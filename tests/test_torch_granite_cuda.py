"""granite-4.0-h-micro's paths on the card (imports no JAX): the flash
kernels at a softmax scale other than ``1/sqrt(hd)`` (Granite's 1/hd, at
hd 64, padded to the kernels' 128), forward and backward, against the
plain attention; the reduced model's loss, gradients, prefill and decode
on the card against the CPU. Every test skips where CUDA is absent:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_granite_cuda.py
"""
import dataclasses

import pytest
import torch

from _torch_parity import CPU, require_cuda
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.registry import get_bundle
from repro_torch.serve.replica import tree_map

pytestmark = pytest.mark.cuda


def test_flash_kernels_take_a_scale():
    """Granite's scale 1/64 at GQA 32/8, hd 64, bf16, S = 300: the forward
    and the dq / dkv backward against the plain version at that scale
    (the bf16 tolerances of the default-scale tests); the default scale is
    the explicit ``1/sqrt(hd)``, launch for launch."""
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((2, 300, 32, 64), generator=g, device=dev).bfloat16()
    k = torch.randn((2, 300, 8, 64), generator=g, device=dev).bfloat16()
    v = torch.randn((2, 300, 8, 64), generator=g, device=dev).bfloat16()
    o, lse = flash_ops.flash_attention(q, k, v, scale=1 / 64)
    po, plse = attention_ref(q, k, v, return_lse=True, scale=1 / 64)
    torch.testing.assert_close(o.float(), po.float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-4)
    d, _ = flash_ops.flash_attention(q, k, v)
    e, _ = flash_ops.flash_attention(q, k, v, scale=64 ** -0.5)
    assert torch.equal(d, e)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    out = flash_ops.FlashAttention.apply(*leaves, True, 0, 1 / 64)
    do = torch.randn(out.shape, generator=g, device=dev)
    grads = torch.autograd.grad(out, leaves, do)
    ref_leaves = [t.detach().clone().requires_grad_() for t in leaves]
    want = torch.autograd.grad(attention_ref(*ref_leaves, scale=1 / 64),
                               ref_leaves, do)
    for a, w in zip(grads, want):
        torch.testing.assert_close(a, w, rtol=3e-4, atol=3e-4)


def test_reduced_granite_on_the_card_matches_the_cpu():
    """Float32 activations: the loss and every leaf's gradient, then a
    prefill of 37 tokens and 4 decode steps through the caches, the card
    against the CPU."""
    dev = require_cuda()
    b = get_bundle("granite-4.0-h-micro", reduced=True)
    b.cfg = dataclasses.replace(b.cfg, act_dtype="float32")
    params = b.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    batch = b.make_batch("train", 2, 70, gen)
    out = {}
    for d in (CPU, dev):
        p = tree_map(lambda t: t.to(d).requires_grad_(), params)
        loss = b.loss(p, {k: v.to(d) for k, v in batch.items()})
        leaves = []
        tree_map(leaves.append, p)
        grads = torch.autograd.grad(loss, leaves)
        caches = b.init_caches(2, 64, 4, dtype=torch.float32, device=d)
        with torch.no_grad():
            pd = tree_map(lambda t: t.detach(), p)
            lg, caches = b.prefill(pd, {"tokens": batch["tokens"][:, :37]
                                        .to(d)}, caches)
            logits = [lg]
            for t in range(37, 41):
                lg, caches = b.decode(pd, caches, {
                    "token": batch["tokens"][:, t:t + 1].to(d)})
                logits.append(lg)
        out[d.type] = (loss.detach().cpu(), [g.cpu() for g in grads],
                       torch.stack(logits).cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=0)
    for a, w in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, w, rtol=1e-3, atol=1e-5)
    torch.testing.assert_close(out["cuda"][2], out["cpu"][2], rtol=1e-3,
                               atol=1e-4)


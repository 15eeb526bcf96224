"""The zoo's families on the card (imports no JAX): the MoE's routing and
combine bit-equal across two launches, with the CPU's routing indices; the
RWKV6 WKV scan and the Mamba2 SSD scan against the CPU's; the reduced
rwkv6, zamba2, qwen2-vl and whisper models on the card against the CPU;
whisper's one-row cross-attention over 1500 frames through the flash
forward. Every test skips where CUDA is absent:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_zoo_cuda.py
"""
import numpy as np
import pytest
import torch

from _torch_parity import CPU, require_cuda
from repro_torch.models import mamba2, moe, rwkv6
from repro_torch.models.registry import get_bundle
from repro_torch.serve.replica import tree_map

pytestmark = pytest.mark.cuda


def _bf16_grid(rng, shape, step=1 / 8):
    """Values on a coarse grid, so bf16 router logits tie as at full width."""
    return torch.from_numpy((rng.integers(-8, 9, shape) * step)
                            .astype(np.float32)).bfloat16()


@pytest.mark.parametrize("T", [1, 1024])
def test_moe_routing_and_combine_bit_equal_and_indices_equal_the_cpus(T):
    """qwen3-moe's widths (D 4096, E 128, top-8; d_ff cut to 256) on
    T tokens in bf16: two launches of ``moe_tokens`` give bit-equal
    outputs (no atomics in the combine), and the card's routing of the same
    bf16 logits (ties included) equals the CPU's, index for index."""
    dev = require_cuda()
    cfg = get_bundle("qwen3-moe-235b-a22b").cfg
    E, D = cfg.n_experts, cfg.d_model
    rng = np.random.default_rng(T)
    xt = _bf16_grid(rng, (T, D))
    p = {"router": _bf16_grid(rng, (D, E), 1 / 64),
         "w_gate": 0.02 * torch.randn(E, D, 256).bfloat16(),
         "w_up": 0.02 * torch.randn(E, D, 256).bfloat16(),
         "w_down": 0.02 * torch.randn(E, 256, D).bfloat16()}
    pd = {k: v.to(dev) for k, v in p.items()}
    a = moe.moe_tokens(pd, xt.to(dev), cfg, torch.bfloat16)
    b = moe.moe_tokens(pd, xt.to(dev), cfg, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.isfinite(a.float()).all()
    logits = (xt @ p["router"]).float()
    cap = moe.capacity(T, cfg)
    got = moe.route(logits.to(dev), cfg.top_k, cap)
    want = moe.route(logits, cfg.top_k, cap)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g.cpu(), w)


def test_moe_training_grads_bit_equal_across_two_launches():
    """The backward through the dispatch and the combine adds in a fixed
    order: two gradients of the reduced MoE's loss are bit-equal."""
    dev = require_cuda()
    tb = get_bundle("qwen3-moe-235b-a22b", reduced=True, top_k=3,
                    n_experts=8)
    p = tb.init(torch.Generator(device=dev).manual_seed(0))
    batch = tb.make_batch("train", 2, 128,
                          torch.Generator(device=dev).manual_seed(1))
    grads = []
    for _ in range(2):
        leaves = {k: v.detach().requires_grad_() for k, v in
                  p["blocks"]["moe"].items()}
        q = dict(p, blocks=dict(p["blocks"], moe=leaves))
        tb.loss(q, batch).backward()
        grads.append([leaves[k].grad for k in sorted(leaves)])
    for g1, g2 in zip(*grads):
        assert torch.equal(g1, g2)


def test_rwkv_scan_on_the_card_matches_the_cpu():
    """``wkv_chunked`` at rwkv6-3b's heads (40 of 64) over S = 300 (padded
    to 304) from a non-zero state: the card against the CPU in float32."""
    dev = require_cuda()
    rng = np.random.default_rng(0)
    B, S, H, K = 2, 300, 40, 64

    def a(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape))
                                .astype(np.float32))
    args = (a(B, S, H, K), a(B, S, H, K), a(B, S, H, K),
            -torch.exp(a(B, S, H, K, scale=0.5)), a(H, K, scale=0.1),
            a(B, H, K, K, scale=0.3))
    want = rwkv6.wkv_chunked(*args)
    got = rwkv6.wkv_chunked(*(t.to(dev) for t in args))
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


def test_rwkv_reduced_model_on_the_card_matches_the_cpu():
    """The reduced rwkv6 in float32, prefill of 37 tokens and 4 decode
    steps: the card's logits against the CPU's."""
    dev = require_cuda()
    tb = get_bundle("rwkv6-3b", reduced=True, act_dtype="float32")
    params = tb.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, tb.cfg.vocab, (2, 37),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for d in (CPU, dev):
        p = {k: (v.to(d) if not isinstance(v, dict) else
                 {a: (b.to(d) if not isinstance(b, dict) else
                      {c: e.to(d) for c, e in b.items()})
                  for a, b in v.items()}) for k, v in params.items()}
        c = tb.init_caches(2, 0, device=d)
        with torch.inference_mode():
            lg, c = tb.prefill(p, {"tokens": toks.to(d)}, c)
            logits = [lg]
            for _ in range(4):
                lg, c = tb.decode(p, c, {"token": lg.argmax(-1)[:, None]})
                logits.append(lg)
        out[d.type] = torch.stack(logits).cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-3, atol=1e-3)


def test_ssd_scan_on_the_card_matches_the_cpu():
    """``ssd_chunked`` at zamba2-1.2b's heads (64 of 64, state 64) over
    S = 300 (padded to 320) from a non-zero state: the card against the
    CPU in float32."""
    dev = require_cuda()
    rng = np.random.default_rng(1)
    B, S, H, P, N = 2, 300, 64, 64, 64

    def a(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape))
                                .astype(np.float32))
    args = (a(B, S, H, P), torch.clamp(-torch.exp(a(B, S, H, scale=0.7)),
                                       min=-20.0),
            a(B, S, N), a(B, S, N), a(B, H, P, N, scale=0.3))
    want = mamba2.ssd_chunked(*args, 64)
    got = mamba2.ssd_chunked(*(t.to(dev) for t in args), 64)
    torch.cuda.synchronize()
    # float32 contractions over N = 64 and 64 steps a chunk, summed in
    # other orders: atol scaled by the largest magnitude
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4,
                                   atol=1e-4 * w.abs().max().item())


def _family_batch(tb, B, S, gen):
    batch = tb.make_batch("prefill", B, S, gen)
    batch.pop("labels")
    return {k: (v.float() if v.is_floating_point() else v)
            for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "qwen2-vl-7b",
                                  "whisper-small"])
def test_reduced_model_on_the_card_matches_the_cpu(arch):
    """The reduced model in float32 (float32 caches), a prefill of 70
    positions (whisper: 35 frames and 35 tokens) and 4 decode steps (vlm:
    the last embedding at the next M-RoPE ids): the card's logits against
    the CPU's."""
    from repro_torch.launch.serve import decode_batch
    dev = require_cuda()
    tb = get_bundle(arch, reduced=True, act_dtype="float32")
    params = tb.init(torch.Generator().manual_seed(0))
    pf = _family_batch(tb, 2, 70, torch.Generator().manual_seed(1))
    out = {}
    for d in (CPU, dev):
        p = tree_map(lambda t: t.to(d), params)
        b = {k: v.to(d) for k, v in pf.items()}
        c = tb.init_caches(2, 80, 4, dtype=torch.float32, device=d)
        with torch.inference_mode():
            lg, c = tb.prefill(p, b, c)
            logits = [lg]
            for i in range(4):
                lg, c = tb.decode(p, c, decode_batch(
                    tb, b, lg.argmax(-1)[:, None], i))
                logits.append(lg)
        out[d.type] = torch.stack(logits).cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-3, atol=1e-3)


def test_whisper_cross_attention_decode_through_the_flash_forward():
    """A one-row query over 1500 frames (whisper-small's decode
    cross-attention: 12 heads of 64, bf16, non-causal) through the flash
    forward, against the plain version."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import layers
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((4, 1, 12, 64), generator=g, device=dev).bfloat16()
    k = torch.randn((4, 1500, 12, 64), generator=g, device=dev).bfloat16()
    v = torch.randn((4, 1500, 12, 64), generator=g, device=dev).bfloat16()
    before = ops.flash_attention.launches
    got = layers.blocked_attention(q, k, v, causal=False, cross=True,
                                   q_block=1)
    assert ops.flash_attention.launches == before + 1
    want = attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)

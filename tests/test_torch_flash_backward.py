"""The port's flash-attention backward (its plain version, which CPU tensors
run, and ``FlashAttention``'s CPU route) against ``jax.grad`` through the
JAX package's Pallas kernels in interpret mode, over causal, windowed,
ragged, GQA and padded-head cases. The CUDA kernels themselves are held
against the plain version in tests/test_torch_kernels_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import elsewhere, np_dtype_cast
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (flash_bwd_from_delta,
                                                     flash_bwd_ref,
                                                     flash_delta)

CASES = [
    # B, Sq, Skv, H, kvH, hd, causal, window, qb, kb
    (2, 37, 37, 4, 2, 32, True, 0, 8, 16),      # ragged S, GQA, padded hd
    (1, 64, 64, 4, 4, 32, True, 7, 16, 16),     # sliding window
    (2, 50, 50, 6, 2, 128, False, 0, 16, 8),    # no mask, GQA rep 3
    (1, 130, 130, 8, 8, 128, True, 0, 64, 64),  # ragged over several tiles
    (2, 20, 45, 4, 1, 32, True, 5, 8, 16),      # Sq < Skv (causal offset)
]
# f32: summation order only; bf16: a few bf16 steps of the grads (the JAX
# kernel rounds each repeated head's dk/dv to bf16 before the GQA sum, the
# port sums in float32 and rounds once)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(B, Sq, Skv, H, kvH, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [np_dtype_cast(rng.standard_normal(s), dtype) for s in
            ((B, Sq, H, hd), (B, Skv, kvH, hd), (B, Skv, kvH, hd),
             (B, Sq, H, hd))]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("B,Sq,Skv,H,kvH,hd,causal,window,qb,kb", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_jax_pallas_grad(B, Sq, Skv, H, kvH, hd, causal,
                                          window, qb, kb, dtype):
    """dq, dk, dv of the plain backward and of ``FlashAttention`` on CPU
    tensors against ``jax.vjp`` through the Pallas forward and backward
    kernels (interpret mode)."""
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _inputs(
        B, Sq, Skv, H, kvH, hd, dtype)

    def f(q, k, v):
        return jax_flash(q, k, v, causal=causal, window=window, q_block=qb,
                         kv_block=kb, interpret=True)

    _, vjp = jax.vjp(f, jq, jk, jv)
    want = vjp(jdo)

    o, lse = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    plain = flash_bwd_ref(tq, tk, tv, o, lse, tdo, causal=causal,
                          window=window)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = ops.FlashAttention.apply(*leaves, causal, window)
    assert out.requires_grad and out.dtype == tq.dtype
    fn = torch.autograd.grad(out, leaves, tdo)
    tol = TOL[dtype]
    for got3 in (plain, fn):
        for got, w, t in zip(got3, want, (tq, tk, tv)):
            assert got.shape == t.shape and got.dtype == t.dtype
            np.testing.assert_allclose(_f32(got), _f32(w), rtol=tol, atol=tol)


def test_function_output_requires_grad_and_cpu_launches_nothing():
    (_, tq), (_, tk), (_, tv), (_, tdo) = _inputs(1, 9, 9, 2, 1, 16,
                                                  "float32")
    before = (ops.flash_attention.launches, ops.flash_bwd_dq.launches,
              ops.flash_bwd_dkv.launches)
    q = tq.clone().requires_grad_()
    o = ops.FlashAttention.apply(q, tk, tv, True, 0)
    assert o.requires_grad
    o.backward(tdo)
    assert q.grad is not None and q.grad.shape == q.shape
    assert (ops.flash_attention.launches, ops.flash_bwd_dq.launches,
            ops.flash_bwd_dkv.launches) == before
    with torch.no_grad():
        assert not ops.FlashAttention.apply(q, tk, tv, True, 0).requires_grad


def test_kernel_wrappers_cpu_route_is_the_plain_split():
    """``flash_bwd_dq`` / ``flash_bwd_dkv`` on CPU tensors return the plain
    version's dq and (dk, dv) from the same delta."""
    (_, tq), (_, tk), (_, tv), (_, tdo) = _inputs(2, 33, 33, 6, 2, 128,
                                                  "float32", seed=3)
    o, lse = ops.flash_attention(tq, tk, tv, causal=True, window=9)
    delta = flash_delta(o, tdo)
    kw = dict(scale=128 ** -0.5, causal=True, window=9)
    dq, dk, dv = flash_bwd_from_delta(tq, tk, tv, tdo, lse, delta,
                                      causal=True, window=9)
    assert torch.equal(ops.flash_bwd_dq(tq, tk, tv, tdo, lse, delta, **kw),
                       dq)
    got_k, got_v = ops.flash_bwd_dkv(tq, tk, tv, tdo, lse, delta, **kw)
    assert torch.equal(got_k, dk) and torch.equal(got_v, dv)


def test_backward_has_no_silent_fallback():
    """A tensor on neither the CPU, a GPU nor meta raises in every
    backward wrapper: the plain version runs only for CPU tensors."""
    m = elsewhere((1, 8, 2, 128))
    s = elsewhere((1, 2, 8))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_attention_bwd(m, m, m, m, s, m)
    for fn in (ops.flash_bwd_dq, ops.flash_bwd_dkv):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(m, m, m, m, s, s, scale=1.0)

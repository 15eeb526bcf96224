"""Port's flash-attention forward (its plain version, which CPU tensors run)
vs the JAX package's Pallas kernel (interpret mode) and its oracle, over the
masking cases of tests/test_flash_attention.py. The CUDA kernel itself is
held against the plain version in tests/test_torch_kernels_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import elsewhere, np_dtype_cast
from repro.kernels.flash_attention.ops import _flash_fwd, flash_attention
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models import layers as L

CASES = [
    # B, S, H, kvH, hd, causal, window, qb, kb  (as test_flash_attention.py)
    (2, 37, 4, 2, 16, True, 0, 8, 16),
    (1, 64, 4, 4, 32, True, 7, 16, 16),
    (2, 50, 6, 2, 64, False, 0, 16, 8),
    (1, 130, 8, 8, 128, True, 0, 64, 64),
    (3, 24, 2, 1, 8, True, 0, 8, 8),
]
# f32: summation order only; bf16: one rounding step of the bf16 output
# (the JAX kernel test's tolerances)
TOL = {"float32": 3e-4, "bfloat16": 2e-2}

_jax_fwd = jax.jit(_flash_fwd, static_argnums=(3, 4, 5, 6, 7))


def _qkv(B, Sq, Skv, H, kvH, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [np_dtype_cast(rng.standard_normal(s), dtype) for s in
            ((B, Sq, H, hd), (B, Skv, kvH, hd), (B, Skv, kvH, hd))]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("B,S,H,kvH,hd,causal,window,qb,kb", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_matches_jax_kernel_and_oracle(
        B, S, H, kvH, hd, causal, window, qb, kb, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, S, S, H, kvH, hd, dtype)
    j_out = flash_attention(jq, jk, jv, causal=causal, window=window,
                            q_block=qb, kv_block=kb, interpret=True)
    # lse: the kernel's second output, from the forward half of its vjp
    _, res = _jax_fwd(jq, jk, jv, causal, window, qb, kb, True)
    j_lse = np.asarray(res[4]).reshape(B, H, -1)[:, :, :S]
    j_ref = jax_ref(jq, jk, jv, causal=causal, window=window)

    o, lse = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    blocked = L.blocked_attention(tq, tk, tv, causal=causal, window=window,
                                  q_block=qb, kv_block=kb, cross=not causal)
    ref = attention_ref(tq, tk, tv, causal=causal, window=window)
    tol = TOL[dtype]
    for got in (o, blocked, ref):
        assert got.dtype == tq.dtype and got.shape == tq.shape
        np.testing.assert_allclose(_f32(got), _f32(j_out), rtol=tol, atol=tol)
        np.testing.assert_allclose(_f32(got), _f32(j_ref), rtol=tol, atol=tol)
    # lse is float32 from float32 arithmetic in both, whatever the input dtype
    np.testing.assert_allclose(lse.numpy(), j_lse, rtol=1e-5, atol=1e-5)


def test_decode_shaped_query_causal_offset():
    """Sq=1 against a longer prefix: the skv - sq offset of the causal mask."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 1, 96, 4, 4, 32, "float32", 1)
    want = jax_ref(jq, jk, jv, causal=True)
    for got in (ops.flash_attention(tq, tk, tv, causal=True)[0],
                L.blocked_attention(tq, tk, tv, causal=True, q_block=8,
                                    kv_block=32)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=3e-4, atol=3e-4)


def test_cpu_runs_plain_version_without_launch():
    (_, tq), (_, tk), (_, tv) = _qkv(1, 8, 8, 2, 2, 128, "bfloat16")
    before = ops.flash_attention.launches
    ops.flash_attention(tq, tk, tv)
    assert ops.flash_attention.launches == before


def test_wrapper_has_no_silent_fallback():
    """A tensor on neither the CPU, a GPU nor meta raises: the plain
    version runs only for CPU tensors."""
    q = elsewhere((1, 8, 2, 128))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_attention(q, q, q)


"""Wrapper around the hand-written flash-attention forward kernel.

``flash_attention(q, k, v)`` returns ``(o, lse)`` as the Pallas forward
``_flash_kernel`` does: the attention output and the per-row float32
log-sum-exp of the scaled, masked scores (which the backward kernels of a
later slice re-derive the probabilities from). On a CUDA tensor it launches
``csrc/flash_fwd.cu``; on a CPU tensor it runs its plain version,
:func:`~.ref.attention_ref` with ``return_lse``. It is a plain function for
now; the ``torch.autograd.Function`` arrives with the backward kernels.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .ref import attention_ref

_HD = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_fwd
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, ctypes.c_float, I, I, P]
        fn.restype = ctypes.c_int
    return lib


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """Flash-attention forward. q: [B, Sq, H, hd]; k, v: [B, Skv, kvH, hd]
    (GQA: H % kvH == 0). Returns ``(o [B, Sq, H, hd], lse [B, H, Sq] f32)``.

    CUDA tensors launch the kernel (hd = 128, float32 or bfloat16, any
    ragged S); anything it does not take raises. CPU tensors run the plain
    version, :func:`~.ref.attention_ref`."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             return_lse=True)
    if not q.is_cuda:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Sq, H, hd = q.shape
    Skv, kvH = k.shape[1], k.shape[2]
    if hd != _HD or k.shape != (B, Skv, kvH, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention kernel takes hd={_HD} and "
                         f"matching k/v; got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % kvH:
        raise ValueError(f"GQA needs H % kvH == 0 (H={H}, kvH={kvH})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16 "
                         f"q/k/v of one dtype; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if Sq < 1 or Skv < 1 or (causal and Sq > Skv):
        raise ValueError(f"flash_attention kernel needs 1 <= Sq <= Skv when "
                         f"causal (Sq={Sq}, Skv={Skv})")
    if B * H > 65535:
        raise ValueError(f"B*H={B * H} exceeds the kernel's grid (65535)")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _lib()
    rc = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                       lse.data_ptr(), _DTYPES[q.dtype], B, H, kvH, Sq, Skv,
                       1.0 / math.sqrt(hd), int(causal), int(window),
                       _build.stream_ptr(q))
    _build.check(lib, rc, "flash_fwd")
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0

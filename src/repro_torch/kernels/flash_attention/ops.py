"""Wrappers around the hand-written flash-attention kernels, forward and
backward, and the ``torch.autograd.Function`` that pairs them.

* :func:`flash_attention` returns ``(o, lse)`` as the Pallas forward
  ``_flash_kernel`` does: the attention output and the per-row float32
  log-sum-exp of the scaled, masked scores. CUDA: ``csrc/flash_fwd.cu``.
* :func:`flash_bwd_dq` and :func:`flash_bwd_dkv` are the two backward
  kernels of ``csrc/flash_bwd.cu`` (``_flash_bwd_dq_kernel`` and
  ``_flash_bwd_dkv_kernel``); :func:`flash_attention_bwd` computes
  ``delta = rowsum(do * o)`` in plain PyTorch, as the JAX wrapper does
  outside Pallas, and launches both.
* :class:`FlashAttention` is ``ops.flash_attention``'s ``jax.custom_vjp``:
  the forward saves ``o`` and ``lse``, the backward runs the pair.

Each wrapper runs its kernel for a CUDA tensor and its plain version
(:mod:`.ref`) for a CPU tensor; for a ``meta`` tensor (the dry run) it
returns empty outputs of the launch's shapes and dtypes, lse included.
Each reports its work to the active counters (:mod:`..work`), counted by
:func:`fwd_work`, :func:`bwd_dq_work` and :func:`bwd_dkv_work` from the
visible (q, k) pairs; anything the kernel does not take raises.
The kernels work on a head dim of 128; the public functions take any hd up
to 128 by zero-padding q, k, v (and do) to 128, as the JAX wrapper pads to
the TPU's lane width, keep the softmax scale of the true hd (``scale``,
by default ``1/sqrt(hd)``), and slice the outputs back.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .. import _build, work
from .ref import attention_ref, flash_bwd_from_delta, flash_delta

_HD = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib(name: str, fn_name: str, argtypes) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_P] * 5 + [_I] * 6 + [_F, _I, _I, _P]
_DQ_ARGS = [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P]
_DKV_ARGS = [_P] * 8 + [_I] * 6 + [_F, _I, _I, _P]


def visible_pairs(Sq: int, Skv: int, window: int, causal: bool) -> int:
    """(q, k) pairs of one (batch, head) that the mask leaves visible: row
    i of a causal mask sees keys ``max(0, i + Skv - Sq - window + 1) ..
    i + Skv - Sq`` (``window = 0``: from 0)."""
    if not causal:
        return Sq * Skv
    lo, hi = Skv - Sq + 1, Skv              # keys row 0 / row Sq-1 see
    if not window or window >= hi:
        return (lo + hi) * Sq // 2
    if window <= lo:
        return window * Sq
    return (lo + window) * (window - lo + 1) // 2 + window * (hi - window)


def fwd_work(B, Sq, Skv, H, kvH, hd, itemsize, causal=True, window=0):
    """(operations, bytes) of one forward: QK^T and PV on the visible
    pairs (two operations a multiply-add); q, k, v read and o written at
    ``itemsize`` bytes a value, lse written in float32."""
    ops = 4.0 * hd * visible_pairs(Sq, Skv, window, causal) * B * H
    nbytes = itemsize * (2 * B * Sq * H * hd + 2 * B * Skv * kvH * hd) \
        + 4.0 * B * H * Sq
    return ops, nbytes


def _bwd_work(n_prod, q_io, kv_io, B, Sq, Skv, H, kvH, hd, itemsize, causal,
              window):
    pairs = visible_pairs(Sq, Skv, window, causal) * B * H
    qb, kvb = itemsize * B * Sq * H * hd, itemsize * B * Skv * kvH * hd
    return (2.0 * hd * pairs * n_prod,
            q_io * qb + kv_io * kvb + 2 * 4.0 * B * H * Sq)


def bwd_dq_work(B, Sq, Skv, H, kvH, hd, itemsize, causal=True, window=0):
    """(operations, bytes) of the dq kernel: QK^T, dO V^T and dS K on the
    visible pairs; q, do, k, v, lse and delta read, dq written."""
    return _bwd_work(3, 4, 2, B, Sq, Skv, H, kvH, hd, itemsize, causal,
                     window)


def bwd_dkv_work(B, Sq, Skv, H, kvH, hd, itemsize, causal=True, window=0):
    """(operations, bytes) of the dkv kernel: QK^T, P^T dO, dO V^T and
    dS^T Q on the visible pairs; q, do, k, v, lse and delta read, dk and
    dv written."""
    return _bwd_work(4, 2, 4, B, Sq, Skv, H, kvH, hd, itemsize, causal,
                     window)


def _report(name, count, q, k, causal, window, hd=None):
    """``count``'s work for these operands, to the active counters."""
    if work.counting():
        B, Sq, H = q.shape[:3]
        work.report(name, *count(B, Sq, k.shape[1], H, k.shape[2],
                                 hd or q.shape[-1], q.element_size(),
                                 causal, window))


def _check(q, k, v, causal: bool, what: str, max_hd: int = _HD) -> None:
    """Raise unless the CUDA kernels take these q/k/v (CUDA or meta)."""
    if not (q.is_cuda or q.is_meta):
        raise ValueError(f"{what}: unsupported device {q.device}")
    B, Sq, H, hd = q.shape
    Skv, kvH = k.shape[1], k.shape[2]
    if not 1 <= hd <= max_hd or k.shape != (B, Skv, kvH, hd) \
            or v.shape != k.shape:
        raise ValueError(f"{what} kernel takes hd <= {max_hd} and matching "
                         f"k/v; got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if H % kvH:
        raise ValueError(f"GQA needs H % kvH == 0 (H={H}, kvH={kvH})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what} kernel takes float32 or bfloat16 q/k/v of "
                         f"one dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    if Sq < 1 or Skv < 1 or (causal and Sq > Skv):
        raise ValueError(f"{what} kernel needs 1 <= Sq <= Skv when causal "
                         f"(Sq={Sq}, Skv={Skv})")
    if B * H > 65535:
        raise ValueError(f"B*H={B * H} exceeds the kernel's grid (65535)")


def _pad(x):
    """[.., hd] -> contiguous [.., 128], zero-padded."""
    if x.shape[-1] != _HD:
        x = F.pad(x, (0, _HD - x.shape[-1]))
    return x.contiguous()


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None):
    """Flash-attention forward. q: [B, Sq, H, hd]; k, v: [B, Skv, kvH, hd]
    (GQA: H % kvH == 0); the scores are ``scale * q k^T`` (``scale``
    defaults to ``1/sqrt(hd)``). Returns ``(o [B, Sq, H, hd], lse [B, H,
    Sq] f32)``.

    CUDA tensors launch the kernel (hd <= 128, float32 or bfloat16, any
    ragged S); anything it does not take raises. CPU tensors run the plain
    version, :func:`~.ref.attention_ref`; meta tensors get the launch's
    empty outputs."""
    if q.device.type == "cpu":
        _report("flash_attention", fwd_work, q, k, causal, window)
        with work.plain_version():
            return attention_ref(q, k, v, causal=causal, window=window,
                                 return_lse=True, scale=scale)
    _check(q, k, v, causal, "flash_attention")
    B, Sq, H, hd = q.shape
    Skv, kvH = k.shape[1], k.shape[2]
    qp, kp, vp = _pad(q), _pad(k), _pad(v)
    o = torch.empty_like(qp)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    _report("flash_attention", fwd_work, q, k, causal, window)
    if q.is_meta:
        return (o if hd == _HD else o[..., :hd]), lse
    lib = _lib("flash_attention", "flash_fwd", _FWD_ARGS)
    rc = lib.flash_fwd(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                       o.data_ptr(), lse.data_ptr(), _DTYPES[q.dtype], B, H,
                       kvH, Sq, Skv,
                       1.0 / math.sqrt(hd) if scale is None else scale,
                       int(causal), int(window), _build.stream_ptr(q))
    _build.check(lib, rc, "flash_fwd")
    flash_attention.launches += 1
    return (o if hd == _HD else o[..., :hd]), lse


def _bwd_args(q, k, v, do, lse, delta, causal, what):
    """Checks of the backward kernels' operands (hd = 128, contiguous)."""
    _check(q, k, v, causal, what, max_hd=_HD)
    if q.shape[-1] != _HD:
        raise ValueError(f"{what} kernel takes hd = {_HD} (the wrapper pads)")
    B, Sq, H, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"{what}: do must match q; got {tuple(do.shape)} "
                         f"{do.dtype}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B, H, Sq) or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"{what}: {name} must be float32 [B, H, Sq] on "
                             f"q's device; got {tuple(t.shape)} {t.dtype} "
                             f"{t.device}")
    for t in (q, k, v, do, lse, delta):
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel takes contiguous operands")


def flash_bwd_dq(q, k, v, do, lse, delta, *, scale: float,
                 causal: bool = True, window: int = 0, hd: int | None = None):
    """dq of the backward: the dq kernel on CUDA tensors (hd = 128,
    contiguous), the plain version on CPU tensors, an empty dq on meta
    ones. q, do [B, Sq, H, hd]; k, v [B, Skv, kvH, hd]; lse, delta [B, H,
    Sq] float32. ``hd``: the true head dim of zero-padded operands (the
    work is counted at it)."""
    if q.device.type == "cpu":
        _report("flash_bwd_dq", bwd_dq_work, q, k, causal, window, hd)
        with work.plain_version():
            return flash_bwd_from_delta(q, k, v, do, lse, delta,
                                        causal=causal, window=window,
                                        scale=scale)[0]
    _bwd_args(q, k, v, do, lse, delta, causal, "flash_bwd_dq")
    B, Sq, H, _ = q.shape
    Skv, kvH = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    _report("flash_bwd_dq", bwd_dq_work, q, k, causal, window, hd)
    if q.is_meta:
        return dq
    lib = _lib("flash_attention_bwd", "flash_bwd_dq", _DQ_ARGS)
    rc = lib.flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                          dq.data_ptr(), _DTYPES[q.dtype], B, H, kvH, Sq,
                          Skv, scale, int(causal), int(window),
                          _build.stream_ptr(q))
    _build.check(lib, rc, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, scale: float,
                  causal: bool = True, window: int = 0,
                  hd: int | None = None):
    """(dk, dv) of the backward, the GQA sum over the heads that share a kv
    head included: the dkv kernel on CUDA tensors, the plain version on CPU
    tensors, empty outputs on meta ones. Operands as :func:`flash_bwd_dq`."""
    if q.device.type == "cpu":
        _report("flash_bwd_dkv", bwd_dkv_work, q, k, causal, window, hd)
        with work.plain_version():
            return flash_bwd_from_delta(q, k, v, do, lse, delta,
                                        causal=causal, window=window,
                                        scale=scale)[1:]
    _bwd_args(q, k, v, do, lse, delta, causal, "flash_bwd_dkv")
    B, Sq, H, _ = q.shape
    Skv, kvH = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _report("flash_bwd_dkv", bwd_dkv_work, q, k, causal, window, hd)
    if q.is_meta:
        return dk, dv
    lib = _lib("flash_attention_bwd", "flash_bwd_dkv", _DKV_ARGS)
    rc = lib.flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype], B,
                           H, kvH, Sq, Skv, scale, int(causal), int(window),
                           _build.stream_ptr(q))
    _build.check(lib, rc, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, scale: float | None = None):
    """Attention backward from the forward's ``o`` and ``lse``: ``delta``
    in plain PyTorch, then the dq and dkv kernels (CUDA; any hd <= 128,
    zero-padded; meta: empty outputs) or their plain versions (CPU), at
    the forward's ``scale`` (by default ``1/sqrt(hd)``). Returns ``(dq,
    dk, dv)`` in the inputs' shapes and dtypes."""
    hd = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    kw = dict(scale=scale, causal=causal, window=window)
    if q.device.type != "cpu":
        _check(q, k, v, causal, "flash_attention_bwd")
    delta = flash_delta(o, do).contiguous()
    if q.device.type == "cpu":
        _report("flash_bwd_dq", bwd_dq_work, q, k, causal, window)
        _report("flash_bwd_dkv", bwd_dkv_work, q, k, causal, window)
        with work.plain_version():
            return flash_bwd_from_delta(q, k, v, do, lse, delta,
                                        causal=causal, window=window,
                                        scale=scale)
    qp, kp, vp, dop = _pad(q), _pad(k), _pad(v), _pad(do.to(q.dtype))
    lse = lse.contiguous()
    dq = flash_bwd_dq(qp, kp, vp, dop, lse, delta, hd=hd, **kw)
    dk, dv = flash_bwd_dkv(qp, kp, vp, dop, lse, delta, hd=hd, **kw)
    if hd != _HD:
        dq, dk, dv = dq[..., :hd], dk[..., :hd], dv[..., :hd]
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: ``FlashAttention.apply(q, k, v,
    causal, window, scale) -> o`` (``scale`` None: ``1/sqrt(hd)``). The
    forward is :func:`flash_attention` and saves ``o`` and ``lse``; the
    backward is :func:`flash_attention_bwd`.
    The kernels on CUDA tensors, the plain versions on CPU tensors, the
    launches' empty outputs on meta tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, window: int = 0,
                scale: float | None = None):
        o, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.scale = causal, window, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal,
                                         window=ctx.window, scale=ctx.scale)
        return dq, dk, dv, None, None, None


flash_attention.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0

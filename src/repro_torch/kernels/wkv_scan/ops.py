"""Wrapper around the hand-written kernels of the WKV scan's chunk
recurrence, and the ``torch.autograd.Function`` that pairs them.

:func:`state_scan` is the inter-chunk state recurrence of RWKV6's chunked
WKV scan (``repro_torch.models.rwkv6.wkv_chunked``): from ``s_0 = s0``,
``entering[i] = s_i`` and ``s_{i+1} = decay[i] * s_i + add[i]``, decay
broadcast over V. Its backward, from ``G_N = d_final`` (zero when absent),
for i = N-1 down to 0: ``d_add[i] = G_{i+1}``, ``d_decay[i][k] = sum_v
G_{i+1}[k, v] entering[i][k, v]``, ``G_i = decay[i] * G_{i+1} +
d_entering[i]``; then ``d_s0 = G_0``, computed only when it is asked for.
It saves ``decay`` and its own output ``entering``, and recomputes nothing.

Each direction has three routes, chosen by the tensors' device: on a CUDA
tensor one launch of ``csrc/wkv_scan.cu``; on a CPU tensor the plain
version (:func:`scan_fwd_plain`, :func:`scan_bwd_plain`, the same loops in
PyTorch); on a ``meta`` tensor (the dry run) the launch's empty outputs.
Each call reports :func:`scan_fwd_work` or :func:`scan_bwd_work` to the
active counters (:mod:`..work`). The kernel route wraps each launch in the
span ``rwkv6.wkv_state`` (:mod:`repro_torch.spans`), which times the
recurrence inside the ``rwkv6.wkv`` span on the profiler's clock; the
plain route, which launches no kernel, opens none.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, work
from .._spans import span

#: the V the kernels take: V / 4 float4 lanes a row, within one warp
TAKES_V = (4, 8, 16, 32, 64, 128)
SPAN = "rwkv6.wkv_state"

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# entry -> its arguments: pointers, n_chunks, rows, V, stream
_ARGTYPES = {"wkv_state_scan_fwd_f32": [_P] * 5 + [_LL, _LL, _I, _P],
             "wkv_state_scan_bwd_f32": [_P] * 7 + [_LL, _LL, _I, _P]}


def _lib() -> ctypes.CDLL:
    lib = _build.load("wkv_scan")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def scan_fwd_work(N: int, B: int, H: int, K: int, V: int):
    """(operations, bytes) of the forward over ``[N, B, H, K, V]``: one
    multiply-add an element a chunk; ``add``, ``decay`` and ``s0`` read
    once, ``entering`` and ``final`` written."""
    R = B * H * K
    return 2.0 * N * R * V, 4.0 * (2 * N * R * V + N * R + 2 * R * V)


def scan_bwd_work(N: int, B: int, H: int, K: int, V: int,
                  d_s0: bool = True):
    """(operations, bytes) of the backward over ``[N, B, H, K, V]``: two
    multiply-adds an element a chunk (the carried gradient and
    ``d_decay``'s products); ``entering``, ``d_entering``, ``decay`` and
    ``d_final`` read once, ``d_add``, ``d_decay`` (and ``d_s0``)
    written."""
    R = B * H * K
    return (4.0 * N * R * V,
            4.0 * (3 * N * R * V + 2 * N * R + R * V * (2 if d_s0 else 1)))


def _check(decay, add, s0):
    """Raise unless ``decay [N, B, H, K]``, ``add [N, B, H, K, V]`` and
    ``s0 [B, H, K, V]`` agree; a kernel route also needs float32,
    contiguous, 16-byte aligned tensors on one device and V in
    :data:`TAKES_V`. Returns ``(N, B, H, K, V)``."""
    if add.ndim != 5 or decay.shape != add.shape[:4] \
            or s0.shape != add.shape[1:] or add.shape[0] < 1:
        raise ValueError(
            f"state_scan takes decay [N, B, H, K], add [N, B, H, K, V] and "
            f"s0 [B, H, K, V], N >= 1; got {tuple(decay.shape)}, "
            f"{tuple(add.shape)}, {tuple(s0.shape)}")
    if add.device.type != "cpu":
        _check_kernel_operands(decay, add, s0)
    return tuple(add.shape)


def _check_kernel_operands(*ts):
    dev = ts[0].device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"state_scan: unsupported device {dev}")
    for t in ts:
        if t.device != dev:
            raise ValueError(f"state_scan: tensors on {dev} and {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"state_scan kernels take float32; got "
                             f"{t.dtype}")
        if not t.is_contiguous() or (not t.is_meta and t.data_ptr() % 16):
            raise ValueError("state_scan kernels take contiguous tensors "
                             "that start 16-byte aligned")
    if ts[1].shape[-1] not in TAKES_V:
        raise ValueError(f"state_scan kernels take V in {TAKES_V}; got "
                         f"V = {ts[1].shape[-1]}")


def scan_fwd_plain(decay, add, s0):
    """The forward as a loop over the chunks, in the inputs' dtype."""
    entering = torch.empty_like(add)
    s = s0
    for i in range(add.shape[0]):
        entering[i] = s
        s = decay[i][..., None] * s + add[i]
    return entering, s


def scan_bwd_plain(decay, entering, d_entering, d_final, d_s0: bool):
    """The backward as a loop over the chunks, from the last: ``(d_decay,
    d_add, d_s0 or None)``; ``d_final`` None is a zero gradient."""
    g = torch.zeros_like(entering[0]) if d_final is None else d_final
    d_add = torch.empty_like(entering)
    d_decay = torch.empty_like(decay)
    for i in reversed(range(entering.shape[0])):
        d_add[i] = g
        d_decay[i] = (g * entering[i]).sum(-1)
        g = decay[i][..., None] * g + d_entering[i]
    return d_decay, d_add, (g if d_s0 else None)


def scan_fwd(decay, add, s0):
    """``decay [N, B, H, K]``, ``add [N, B, H, K, V]``, ``s0 [B, H, K, V]``
    -> ``(entering [N, B, H, K, V], final [B, H, K, V])``: one launch on
    CUDA tensors, :func:`scan_fwd_plain` on CPU ones, empty outputs on meta
    ones."""
    N, B, H, K, V = _check(decay, add, s0)
    if work.counting():
        work.report("wkv_state_fwd", *scan_fwd_work(N, B, H, K, V))
    if add.device.type == "cpu":
        with work.plain_version():
            return scan_fwd_plain(decay, add, s0)
    entering, final = torch.empty_like(add), torch.empty_like(s0)
    if add.is_meta:
        return entering, final
    lib = _lib()
    with span(SPAN):
        rc = lib.wkv_state_scan_fwd_f32(
            decay.data_ptr(), add.data_ptr(), s0.data_ptr(),
            entering.data_ptr(), final.data_ptr(), N, B * H * K, V,
            _build.stream_ptr(add))
    _build.check(lib, rc, "wkv_state_scan_fwd_f32")
    scan_fwd.launches += 1
    return entering, final


def scan_bwd(decay, entering, d_entering, d_final, d_s0: bool = True):
    """The backward of :func:`scan_fwd`: ``(d_decay [N, B, H, K], d_add
    [N, B, H, K, V], d_s0 [B, H, K, V] or None)``. ``d_final`` None is a
    zero gradient; ``d_s0`` False skips its store. One launch on CUDA
    tensors, :func:`scan_bwd_plain` on CPU ones, empty outputs on meta
    ones."""
    N, B, H, K, V = _check(decay, entering, entering[0])
    if d_entering.shape != entering.shape or (
            d_final is not None and d_final.shape != entering.shape[1:]):
        raise ValueError(f"state_scan backward: gradients of shapes "
                         f"{tuple(d_entering.shape)} and "
                         f"{None if d_final is None else tuple(d_final.shape)}"
                         f" for entering {tuple(entering.shape)}")
    if work.counting():
        work.report("wkv_state_bwd", *scan_bwd_work(N, B, H, K, V, d_s0))
    if entering.device.type == "cpu":
        with work.plain_version():
            return scan_bwd_plain(decay, entering, d_entering, d_final, d_s0)
    _check_kernel_operands(decay, d_entering,
                           *(() if d_final is None else (d_final,)))
    d_add, d_decay = torch.empty_like(entering), torch.empty_like(decay)
    ds0 = torch.empty_like(entering[0]) if d_s0 else None
    if entering.is_meta:
        return d_decay, d_add, ds0
    lib = _lib()
    with span(SPAN):
        rc = lib.wkv_state_scan_bwd_f32(
            decay.data_ptr(), entering.data_ptr(), d_entering.data_ptr(),
            None if d_final is None else d_final.data_ptr(),
            d_add.data_ptr(), d_decay.data_ptr(),
            None if ds0 is None else ds0.data_ptr(), N, B * H * K, V,
            _build.stream_ptr(entering))
    _build.check(lib, rc, "wkv_state_scan_bwd_f32")
    scan_bwd.launches += 1
    return d_decay, d_add, ds0


class StateScan(torch.autograd.Function):
    """Differentiable :func:`scan_fwd`: ``StateScan.apply(decay, add, s0)
    -> (entering, final)``. Saves ``decay`` and ``entering``; the backward
    is :func:`scan_bwd`."""

    @staticmethod
    def forward(ctx, decay, add, s0):
        entering, final = scan_fwd(decay, add, s0)
        ctx.save_for_backward(decay, entering)
        ctx.set_materialize_grads(False)
        return entering, final

    @staticmethod
    def backward(ctx, d_entering, d_final):
        decay, entering = ctx.saved_tensors
        if d_entering is None:
            d_entering = torch.zeros_like(entering)
        d_final = None if d_final is None else d_final.contiguous()
        d_decay, d_add, d_s0 = scan_bwd(decay, entering,
                                        d_entering.contiguous(), d_final,
                                        d_s0=ctx.needs_input_grad[2])
        return d_decay, d_add, d_s0


def state_scan(decay, add, s0):
    """``decay [N, B, H, K]``, ``add [N, B, H, K, V]``, ``s0 [B, H, K, V]``
    -> ``(entering [N, B, H, K, V], final [B, H, K, V])``: the chunk
    recurrence, differentiable (:class:`StateScan`)."""
    return StateScan.apply(decay, add, s0)


scan_fwd.launches = 0
scan_bwd.launches = 0

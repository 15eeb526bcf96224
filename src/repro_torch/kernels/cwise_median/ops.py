"""Wrappers around the hand-written coordinate-wise order-statistic kernels:
the median, the trimmed mean and MeaMed, one shared sorting network.

The kernel backends of the ``median``, ``trimmed_mean`` and ``meamed``
aggregators; call sites reach them through :mod:`repro_torch.agg.dispatch`.
Each takes one stack ``[n <= 64, d]`` or a batch of stacks ``[B, n, d]``
(the receivers of one simulator step: one launch for all of them). On a CUDA
tensor the wrapper launches ``csrc/cwise_median.cu``; on a CPU tensor it runs
its ``*_plain`` version, which applies the same :func:`_tile` contract and
repeats the kernel's arithmetic in plain PyTorch, so the two agree bit for
bit.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import _BIG, sort_stack

MAX_N = 64

_ENTRY = {"cwise_median_f32": False, "cwise_trimmed_mean_f32": True,
          "cwise_meamed_f32": True}


def _lib() -> ctypes.CDLL:
    lib = _build.load("cwise_median")
    for name, takes_f in _ENTRY.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                            ctypes.c_int]
                           + ([ctypes.c_int] if takes_f else [])
                           + [ctypes.c_longlong, ctypes.c_void_p])
            fn.restype = ctypes.c_int
    return lib


def _tile(x):
    """The kernel's view of an ``[n, d]`` (or ``[B, n, d]``) stack: float32,
    rows padded to the next power of two with ``_BIG``, NaN mapped to
    ``_BIG`` (NaN would poison the min/max compare-exchanges). Pads and NaN
    payloads sort last. Mirrors ``repro.kernels.cwise_median.ops._tile``
    (without its lane padding of d, which the TPU's tiling needed)."""
    n, d = x.shape[-2:]
    if n > MAX_N:
        raise ValueError(f"cwise order-statistic kernels are sized for "
                         f"replica stacks n <= {MAX_N} (got n={n})")
    n_pow2 = 1
    while n_pow2 < n:
        n_pow2 *= 2
    xf = x.float()
    xf = torch.where(torch.isnan(xf), _BIG, xf)
    pad = torch.full(x.shape[:-2] + (n_pow2 - n, d), _BIG,
                     dtype=torch.float32, device=x.device)
    return torch.cat([xf, pad], dim=-2), n_pow2


def _sorted_rows(x):
    """The padded stack sorted over its row axis: ``[n_pow2, ..., d]``."""
    return sort_stack(_tile(x)[0].movedim(-2, 0))


def _div(a, k: int):
    """``a / k`` as an elementwise true division (a scalar divisor may run as
    a multiplication by its reciprocal on the card), as the kernel does."""
    return a / torch.full_like(a, float(k))


def cwise_median_plain(x):
    """``[.., n, d] -> [.., d]``: :func:`_tile`, sort, then row ``n // 2``
    for odd n and the mean of the two middle rows for even n — the values
    of ``repro.agg.rules.median_stack``."""
    n = x.shape[-2]
    xs = _sorted_rows(x)
    if n % 2:
        return xs[n // 2]
    return 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def cwise_trimmed_mean_plain(x, f: int):
    """``[.., n, d] -> [.., d]``: sorted rows ``f .. n-f-1`` added in order,
    divided by ``n - 2f`` (``_trimmed_mean_kernel``)."""
    n = x.shape[-2]
    xs = _sorted_rows(x)
    acc = xs[f]
    for i in range(f + 1, n - f):
        acc = acc + xs[i]
    return _div(acc, n - 2 * f)


def cwise_meamed_plain(x, f: int):
    """``[.., n, d] -> [.., d]``: the window scan of ``_meamed_kernel`` —
    the best of the f+1 windows of n-f consecutive sorted rows by the larger
    endpoint distance to the median, ties broken by the smaller in-window
    distance sum. ``fmax``/``fmin`` as the kernel's ``fmaxf``/``fminf``."""
    n = x.shape[-2]
    m = n - f
    s = _sorted_rows(x)
    med = 0.5 * (s[(n - 1) // 2] + s[n // 2])
    dist = [torch.abs(s[j] - med) for j in range(n)]
    win_sum, win_dsum = s[0], dist[0]
    for j in range(1, m):
        win_sum = win_sum + s[j]
        win_dsum = win_dsum + dist[j]
    best_sum, best_dsum = win_sum, win_dsum
    best_d = torch.fmax(med - s[0], s[m - 1] - med)
    for i in range(1, f + 1):
        win_sum = (win_sum - s[i - 1]) + s[i + m - 1]
        win_dsum = (win_dsum - dist[i - 1]) + dist[i + m - 1]
        dd = torch.fmax(med - s[i], s[i + m - 1] - med)
        take = (dd < best_d) | ((dd == best_d) & (win_dsum < best_dsum))
        best_sum = torch.where(take, win_sum, best_sum)
        best_dsum = torch.where(take, win_dsum, best_dsum)
        best_d = torch.fmin(best_d, dd)
    return _div(best_sum, m)


def _launch(entry: str, wrapper, x, f: int | None):
    """Shared launch of one order-statistic kernel on ``[n, d]`` or
    ``[B, n, d]`` (a non-float32 stack is widened first, as the JAX wrapper
    does)."""
    if not x.is_cuda:
        raise ValueError(f"{entry}: unsupported device {x.device}")
    if x.ndim not in (2, 3) or not 1 <= x.shape[-2] <= MAX_N \
            or x.shape[-1] < 1 or (x.ndim == 3 and not 1 <= x.shape[0]
                                   <= 65535):
        raise ValueError(f"{entry}: the kernel takes an [n <= {MAX_N}, d] "
                         f"or [B, n, d] stack; got {tuple(x.shape)}")
    n, d = x.shape[-2:]
    B = x.shape[0] if x.ndim == 3 else 1
    x = x.float().contiguous()
    out = torch.empty(x.shape[:-2] + (d,), dtype=torch.float32,
                      device=x.device)
    lib = _lib()
    args = [x.data_ptr(), out.data_ptr(), B, n]
    if f is not None:
        args.append(f)
    rc = getattr(lib, entry)(*args, d, _build.stream_ptr(x))
    _build.check(lib, rc, entry)
    wrapper.launches += 1
    return out


def cwise_median(x):
    """``[n, d] -> [d]`` or ``[B, n, d] -> [B, d]`` float32 coordinate-wise
    median (1 <= n <= 64): the kernel on a CUDA tensor,
    :func:`cwise_median_plain` on a CPU one."""
    if x.device.type == "cpu":
        return cwise_median_plain(x)
    return _launch("cwise_median_f32", cwise_median, x, None)


def cwise_trimmed_mean(x, f: int):
    """Trimmed mean (drop the f lowest and f highest; n > 2f) of ``[n, d]``
    or ``[B, n, d]``: the kernel on a CUDA tensor,
    :func:`cwise_trimmed_mean_plain` on a CPU one."""
    if x.shape[-2] <= 2 * f or f < 0:
        raise ValueError(f"trimmed_mean needs n > 2f (n={x.shape[-2]}, "
                         f"f={f})")
    if x.device.type == "cpu":
        return cwise_trimmed_mean_plain(x, f)
    return _launch("cwise_trimmed_mean_f32", cwise_trimmed_mean, x, f)


def cwise_meamed(x, f: int):
    """Mean around the median (n > f) of ``[n, d]`` or ``[B, n, d]``: the
    kernel on a CUDA tensor, :func:`cwise_meamed_plain` on a CPU one."""
    if x.shape[-2] <= f or f < 0:
        raise ValueError(f"meamed needs n > f (n={x.shape[-2]}, f={f})")
    if x.device.type == "cpu":
        return cwise_meamed_plain(x, f)
    return _launch("cwise_meamed_f32", cwise_meamed, x, f)


cwise_median.launches = 0
cwise_trimmed_mean.launches = 0
cwise_meamed.launches = 0

"""Wrapper around the hand-written coordinate-wise median kernel.

The kernel backend of the ``median`` aggregator; call sites reach it through
:mod:`repro_torch.agg.dispatch`, which views any ``[n <= 64, ...]`` stack as
``[n, prod(rest)]``. On a CUDA tensor :func:`cwise_median` launches
``csrc/cwise_median.cu``; on a CPU tensor it runs
:func:`cwise_median_plain`, which applies the same :func:`_tile` contract in
plain PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import _BIG, sort_stack

MAX_N = 64


def _lib() -> ctypes.CDLL:
    lib = _build.load("cwise_median")
    fn = lib.cwise_median_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _tile(x):
    """The kernel's view of an ``[n, d]`` stack: float32, rows padded to the
    next power of two with ``_BIG``, NaN mapped to ``_BIG`` (NaN would
    poison the min/max compare-exchanges). Pads and NaN payloads sort last.
    Mirrors ``repro.kernels.cwise_median.ops._tile`` (without its lane
    padding of d, which the TPU's tiling needed)."""
    n, d = x.shape
    if n > MAX_N:
        raise ValueError(f"cwise median kernel is sized for replica stacks "
                         f"n <= {MAX_N} (got n={n})")
    n_pow2 = 1
    while n_pow2 < n:
        n_pow2 *= 2
    xf = x.float()
    xf = torch.where(torch.isnan(xf), _BIG, xf)
    pad = torch.full((n_pow2 - n, d), _BIG, dtype=torch.float32,
                     device=x.device)
    return torch.cat([xf, pad]), n_pow2


def cwise_median_plain(x):
    """[n, d] -> [d] float32: :func:`_tile`, sort, then row ``n // 2`` for
    odd n and the mean of the two middle rows for even n — the values of
    ``repro.agg.rules.median_stack``."""
    n = x.shape[0]
    xs = sort_stack(_tile(x)[0])
    if n % 2:
        return xs[n // 2]
    return 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def cwise_median(x):
    """[n, d] -> [d] float32 coordinate-wise median (1 <= n <= 64).

    CUDA tensors launch the kernel (a non-float32 stack is widened to
    float32 first, as the JAX wrapper does); CPU tensors run
    :func:`cwise_median_plain`."""
    if x.device.type == "cpu":
        return cwise_median_plain(x)
    if not x.is_cuda:
        raise ValueError(f"cwise_median: unsupported device {x.device}")
    if x.ndim != 2 or not 1 <= x.shape[0] <= MAX_N:
        raise ValueError(f"cwise median kernel takes an [n <= {MAX_N}, d] "
                         f"stack; got {tuple(x.shape)}")
    n, d = x.shape
    x = x.float().contiguous()
    out = torch.empty((d,), dtype=torch.float32, device=x.device)
    lib = _lib()
    rc = lib.cwise_median_f32(x.data_ptr(), out.data_ptr(), n, d,
                              _build.stream_ptr(x))
    _build.check(lib, rc, "cwise_median_f32")
    cwise_median.launches += 1
    return out


cwise_median.launches = 0

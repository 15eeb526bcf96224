"""Wrapper around the hand-written Gram kernel.

The kernel backend of every distance-based aggregator (MDA, the Krum family)
and of ``l2_diameter``; call sites reach it through
:mod:`repro_torch.agg.dispatch`. :func:`gram` takes one stack ``[n <= 64, d]``
or a batch ``[B, n, d]`` (the servers of one simulator step: one launch for
all of them). On a CUDA tensor it launches ``csrc/gram.cu``; on a CPU tensor
it runs :func:`gram_plain`, which splits d into the kernel's chunks and adds
the chunks' partial Grams (the sums inside a chunk run in another order, so
the two agree to float32 summation order, not bit for bit).
:func:`launch_plan` is the launch's whole shape: which kernel, the width of
its loads and the chunks.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from .ref import sqdists_from_gram

MAX_N = 64
MAX_REG_N = 8         # largest n of the register kernel (gram.cu MAXN_REG)
TILE = 128            # columns of a chunk's tiles (gram.cu TW)
# 2 blocks on each of the H100's 132 SMs: at the training paths' shapes the
# fastest of 132-2112 (tools/gram_target_blocks.py)
TARGET_BLOCKS = 264


def _lib() -> ctypes.CDLL:
    lib = _build.load("pairwise_sqdist")
    fn = lib.gram_f32
    if fn.argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, I, I, LL, LL, I, I, P]
        fn.restype = ctypes.c_int
    return lib


def chunking(batch: int, d: int) -> tuple[int, int]:
    """(columns per chunk, number of chunks) for ``batch`` stacks of width
    ``d``: whole 128-column tiles, about ``TARGET_BLOCKS`` blocks in all."""
    tiles = -(-d // TILE)
    want = max(1, min(tiles, -(-TARGET_BLOCKS // batch)))
    chunk = -(-tiles // want) * TILE
    return chunk, -(-d // chunk)


class GramPlan(NamedTuple):
    """How :func:`gram` launches ``gram.cu`` for one stack shape."""
    path: str      # "register" (n <= MAX_REG_N) or "general" (the rest)
    vec: int       # floats per load on the register path: 4, 2 or 1
    chunk: int     # columns per block, whole 128-column tiles
    n_chunks: int


def launch_plan(batch: int, n: int, d: int, ptr: int) -> GramPlan:
    """The launch for ``batch`` stacks of ``n`` rows of width ``d`` whose
    data starts at address ``ptr``: the register kernel for n <= 8, with
    the widest load (16, 8 or 4 bytes) that divides every row's start (d
    and ``ptr`` both aligned to it), else the general kernel; the chunks of
    :func:`chunking`."""
    chunk, n_chunks = chunking(batch, d)
    if n > MAX_REG_N:
        return GramPlan("general", 1, chunk, n_chunks)
    vec = next(v for v in (4, 2, 1) if d % v == 0 and ptr % (4 * v) == 0)
    return GramPlan("register", vec, chunk, n_chunks)


def gram_plain(x):
    """``[.., n, d] -> [.., n, n]`` float32: the partial Gram of each of the
    kernel's chunks, then their sum."""
    x = x.float()
    n, d = x.shape[-2:]
    batch = x[..., 0, 0].numel()
    chunk, n_chunks = chunking(batch, d)
    xp = torch.nn.functional.pad(x, (0, n_chunks * chunk - d))
    xc = xp.reshape(x.shape[:-1] + (n_chunks, chunk)).movedim(-2, -3)
    return (xc @ xc.mT).sum(dim=-3)


def gram(x):
    """``[n, d] -> [n, n]`` or ``[B, n, d] -> [B, n, n]`` float32 Gram
    (1 <= n <= 64): the kernel on a CUDA tensor, :func:`gram_plain` on a CPU
    one."""
    if x.device.type == "cpu":
        return gram_plain(x)
    if not x.is_cuda:
        raise ValueError(f"gram: unsupported device {x.device}")
    if x.ndim not in (2, 3) or not 1 <= x.shape[-2] <= MAX_N \
            or x.shape[-1] < 1 or (x.ndim == 3 and not 1 <= x.shape[0]
                                   <= 65535):
        raise ValueError(f"gram kernel takes an [n <= {MAX_N}, d] or "
                         f"[B, n, d] stack; got {tuple(x.shape)}")
    n, d = x.shape[-2:]
    B = x.shape[0] if x.ndim == 3 else 1
    x = x.float().contiguous()
    plan = launch_plan(B, n, d, x.data_ptr())
    chunk, n_chunks = plan.chunk, plan.n_chunks
    partial = torch.empty((B, n_chunks, n * (n + 1) // 2),
                          dtype=torch.float32, device=x.device)
    g = torch.empty(x.shape[:-2] + (n, n), dtype=torch.float32,
                    device=x.device)
    lib = _lib()
    rc = lib.gram_f32(x.data_ptr(), partial.data_ptr(), g.data_ptr(), B, n,
                      d, chunk, n_chunks, plan.vec, _build.stream_ptr(x))
    _build.check(lib, rc, "gram_f32")
    gram.launches += 1
    return g


gram.launches = 0


def pairwise_sqdists(x):
    """``[.., n, d] -> [.., n, n]`` squared L2 distances via :func:`gram`."""
    return sqdists_from_gram(gram(x))

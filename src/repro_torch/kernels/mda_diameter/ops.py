"""Wrappers around the hand-written exact MDA selection kernel.

The kernel backend of exact MDA, reached through
:mod:`repro_torch.agg.dispatch`. :func:`mda_select` takes the distances of
one receiver ``[n, n]`` or of a batch ``[B, n, n]`` and the number f of
inputs to leave out, and returns the diameters of the C(n, n - f) subsets of
:func:`subset_masks` and the averaging weights of the first minimum; on a
CUDA tensor it is one launch of ``csrc/mda_diameter.cu``, with the masks as
uint64 bitmasks, built once per mask table and kept on the device.
:func:`subset_diameters` launches the same kernel for the diameters alone.
On a CPU tensor each runs its ``*_plain`` version. A max does not depend on
its order and the argmin follows ``torch.argmin``'s order, so the two agree
exactly. On a ``meta`` tensor (the dry run) each returns the launch's empty
outputs (the host mask table is read as on the card). Each call reports
:func:`select_work` to the active counters (:mod:`..work`).
"""
from __future__ import annotations

import ctypes
import itertools
import math
from functools import lru_cache

import numpy as np
import torch

from .. import _build, work

MAX_N = 64
NEG = -3.4e38      # the diameter of an empty subset, as the Pallas kernel

# (id of the host mask table, device) -> (table, bitmask tensor); the table
# is kept so its id cannot be reused while the entry lives
_BITMASKS: dict[tuple, tuple] = {}


@lru_cache(maxsize=None)
def subset_masks(n: int, f: int) -> np.ndarray:
    """All C(n, n-f) subsets of size n-f as a static bool mask array
    ``[S, n]``, in ``itertools.combinations`` order."""
    if not 0 <= f < n:
        raise ValueError(f"need 0 <= f < n, got n={n} f={f}")
    masks = np.zeros((math.comb(n, n - f), n), dtype=bool)
    for i, c in enumerate(itertools.combinations(range(n), n - f)):
        masks[i, list(c)] = True
    return masks


def n_subsets(n: int, f: int) -> int:
    return math.comb(n, n - f)


@lru_cache(maxsize=None)
def _mask_table(n: int, f: int, device: str) -> torch.Tensor:
    """:func:`subset_masks` as a bool tensor on ``device``, copied once."""
    return torch.from_numpy(subset_masks(n, f)).to(device)


def _lib() -> ctypes.CDLL:
    lib = _build.load("mda_diameter")
    fn = lib.mda_select_f32
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, P, I, I, I, P]
        fn.restype = ctypes.c_int
    return lib


def select_work(B: int, n: int, S: int, k: int, weights: bool = True):
    """(operations, bytes) of one launch over ``[B, n, n]`` distances and S
    subsets of k members: a max over each subset's k x k pairs; the
    distances and the int64 bitmasks read once, the ``[B, S]`` diameters
    (and the ``[B, n]`` weights) written."""
    return (float(B * S * k * k),
            4.0 * (B * n * n + B * S + (B * n if weights else 0)) + 8.0 * S)


def _report(d2, masks, weights: bool):
    if work.counting():
        n = d2.shape[-1]
        S = np.shape(masks)[0]
        k = int(np.asarray(masks[0].cpu() if isinstance(masks, torch.Tensor)
                           else masks[0]).sum())
        B = d2.shape[0] if d2.ndim == 3 else 1
        work.report("subset_diameters", *select_work(B, n, S, k, weights))


def bitmasks(masks, device) -> torch.Tensor:
    """``[S, n]`` bool masks (n <= 64) -> ``[S]`` int64 tensor on
    ``device`` holding each mask's members as bits (bit i = input i),
    cached per host mask table."""
    key = (id(masks), str(device))
    hit = _BITMASKS.get(key)
    if hit is not None and hit[0] is masks:
        return hit[1]
    m = np.asarray(masks.cpu() if isinstance(masks, torch.Tensor) else masks,
                   bool)
    if m.ndim != 2 or not 1 <= m.shape[1] <= MAX_N:
        raise ValueError(f"subset masks must be [S, n <= {MAX_N}] bool; got "
                         f"{m.shape}")
    bits = (m.astype(np.uint64) << np.arange(m.shape[1], dtype=np.uint64))
    bits = np.bitwise_or.reduce(bits, axis=1).view(np.int64)
    t = torch.from_numpy(bits.copy()).to(device)
    _BITMASKS[key] = (masks, t)
    return t


def subset_diameters_plain(d2, masks):
    """``[.., n, n]``, ``[S, n]`` -> ``[.., S]``: the largest distance
    between two members of each subset, -3.4e38 for an empty one."""
    masks = torch.as_tensor(np.asarray(masks, bool) if not isinstance(
        masks, torch.Tensor) else masks, device=d2.device).bool()
    pair = masks[:, :, None] & masks[:, None, :]
    vals = torch.where(pair, d2.float()[..., None, :, :], NEG)
    return torch.amax(vals, dim=(-2, -1))


def mda_select_plain(d2, f: int):
    """``[.., n, n]`` -> (diameters ``[.., S]``, weights ``[.., n]``): the
    diameters of :func:`subset_masks` ``(n, f)``, their first minimum
    (``torch.argmin``: the first NaN, else the lowest index among equal
    minima) and its mask over n - f as float32 weights."""
    n = d2.shape[-1]
    masks = _mask_table(n, f, str(d2.device))
    diam = subset_diameters_plain(d2, masks)
    best = torch.argmin(diam, dim=-1)
    return diam, masks[best].float() / (n - f)


def _launch(d2, masks, weights: bool):
    """One launch of the kernel on ``[n, n]`` or ``[B, n, n]``: the
    diameters, and the weights too when ``weights`` (a meta ``d2``: the
    launch's empty outputs)."""
    if not (d2.is_cuda or d2.is_meta):
        raise ValueError(f"mda_diameter: unsupported device {d2.device}")
    n = d2.shape[-1]
    if d2.ndim not in (2, 3) or d2.shape[-2] != n or not 1 <= n <= MAX_N \
            or (d2.ndim == 3 and not 1 <= d2.shape[0] <= 65535):
        raise ValueError(f"the mda_diameter kernel takes [n <= {MAX_N}, n] "
                         f"or [B, n, n] distances; got {tuple(d2.shape)}")
    if np.shape(masks)[1] != n:
        raise ValueError(f"masks are over {np.shape(masks)[1]} inputs, "
                         f"distances over {n}")
    bits = bitmasks(masks, d2.device)
    S = bits.shape[0]
    B = d2.shape[0] if d2.ndim == 3 else 1
    d2 = d2.float().contiguous()
    diam = torch.empty(d2.shape[:-2] + (S,), dtype=torch.float32,
                       device=d2.device)
    w = (torch.empty(d2.shape[:-1], dtype=torch.float32, device=d2.device)
         if weights else None)
    _report(d2, masks, weights)
    if d2.is_meta:
        return diam, w
    lib = _lib()
    rc = lib.mda_select_f32(d2.data_ptr(), bits.data_ptr(), diam.data_ptr(),
                            None if w is None else w.data_ptr(), B, n, S,
                            _build.stream_ptr(d2))
    _build.check(lib, rc, "mda_select_f32")
    subset_diameters.launches += 1
    return diam, w


def mda_select(d2, f: int):
    """Exact MDA selection of ``[n, n]`` or ``[B, n, n]`` distances ->
    (diameters ``[.., S]``, weights ``[.., n]``) as :func:`mda_select_plain`:
    one kernel launch on a CUDA tensor, the plain version on a CPU one."""
    if d2.device.type == "cpu":
        _report(d2, subset_masks(d2.shape[-1], f), True)
        with work.plain_version():
            return mda_select_plain(d2, f)
    return _launch(d2, subset_masks(d2.shape[-1], f), weights=True)


def subset_diameters(d2, masks):
    """Subset diameters of ``[n, n]`` -> ``[S]`` or ``[B, n, n]`` ->
    ``[B, S]``: the kernel (no weights) on a CUDA tensor,
    :func:`subset_diameters_plain` on a CPU one. ``masks`` is a host table
    ``[S, n]`` such as :func:`subset_masks`'s."""
    if d2.device.type == "cpu":
        _report(d2, masks, False)
        with work.plain_version():
            return subset_diameters_plain(d2, masks)
    return _launch(d2, masks, weights=False)[0]


# launches of the kernel, by either wrapper
subset_diameters.launches = 0

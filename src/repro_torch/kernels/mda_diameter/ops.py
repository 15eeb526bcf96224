"""Wrapper around the hand-written subset-diameter kernel.

The kernel backend of exact MDA selection, reached through
:mod:`repro_torch.agg.dispatch`; the subset enumeration and the argmin stay
in :mod:`repro_torch.agg.rules`. :func:`subset_diameters` takes the distances
of one receiver ``[n, n]`` or of a batch ``[B, n, n]`` and the ``[S, n]``
subset masks. On a CUDA tensor it launches ``csrc/mda_diameter.cu`` with the
masks as uint64 bitmasks, built once per mask table and kept on the device;
on a CPU tensor it runs :func:`subset_diameters_plain`. A max does not depend
on its order, so the two agree exactly.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build

MAX_N = 64
NEG = -3.4e38      # the diameter of an empty subset, as the Pallas kernel

# (id of the host mask table, device) -> (table, bitmask tensor); the table
# is kept so its id cannot be reused while the entry lives
_BITMASKS: dict[tuple, tuple] = {}


def _lib() -> ctypes.CDLL:
    lib = _build.load("mda_diameter")
    fn = lib.subset_diameters_f32
    if fn.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, P, P, I, I, I, P]
        fn.restype = ctypes.c_int
    return lib


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


def subset_diameters(d2, masks):
    """Subset diameters of ``[n, n]`` -> ``[S]`` or ``[B, n, n]`` ->
    ``[B, S]``: the kernel on a CUDA tensor, :func:`subset_diameters_plain`
    on a CPU one. ``masks`` is the host table ``[S, n]`` of
    ``agg.rules.subset_masks``."""
    if d2.device.type == "cpu":
        return subset_diameters_plain(d2, masks)
    if not d2.is_cuda:
        raise ValueError(f"subset_diameters: unsupported device {d2.device}")
    n = d2.shape[-1]
    if d2.ndim not in (2, 3) or d2.shape[-2] != n or not 1 <= n <= MAX_N \
            or (d2.ndim == 3 and not 1 <= d2.shape[0] <= 65535):
        raise ValueError(f"subset_diameters kernel takes [n <= {MAX_N}, n] "
                         f"or [B, n, n] distances; got {tuple(d2.shape)}")
    bits = bitmasks(masks, d2.device)
    if np.shape(masks)[1] != n:
        raise ValueError(f"masks are over {np.shape(masks)[1]} inputs, "
                         f"distances over {n}")
    S = bits.shape[0]
    B = d2.shape[0] if d2.ndim == 3 else 1
    d2 = d2.float().contiguous()
    out = torch.empty(d2.shape[:-2] + (S,), dtype=torch.float32,
                      device=d2.device)
    lib = _lib()
    rc = lib.subset_diameters_f32(d2.data_ptr(), bits.data_ptr(),
                                  out.data_ptr(), B, n, S,
                                  _build.stream_ptr(d2))
    _build.check(lib, rc, "subset_diameters_f32")
    subset_diameters.launches += 1
    return out


subset_diameters.launches = 0

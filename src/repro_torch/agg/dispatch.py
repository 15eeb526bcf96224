"""Dispatch: route the median primitive to its kernel or its plain version.

The rule is the device of the tensor, with no option and no fallback:

  * a CUDA stack ``[n <= 64, ...]`` launches the coordinate-wise median
    kernel, viewed as ``[n, prod(rest)]`` — a coordinate-wise median of
    ``[R, slots, V]`` is the median of ``[R, slots * V]``, so every serving
    read runs the kernel (the JAX dispatch sends only 2-D stacks to its
    Pallas kernel because of a BlockSpec limit, not the rule's meaning);
  * a CPU stack ``[n <= 64, ...]`` runs the kernel wrapper's plain version;
  * a stack with n > 64 runs plain :func:`rules.coordinate_median`, as the
    JAX package does beyond the kernel's limit.

Values are the same on every route (``tests/test_torch_agg.py``).
"""
from __future__ import annotations

import torch

from ..kernels.cwise_median import ops
from . import rules


def cwise_median(x: torch.Tensor) -> torch.Tensor:
    """[n, ...] -> [...] float32 coordinate-wise median."""
    n = x.shape[0]
    if n > ops.MAX_N:
        return rules.coordinate_median(x.float())
    return ops.cwise_median(x.reshape(n, -1)).reshape(x.shape[1:])


def median(x: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median through the dispatch, in the input's dtype."""
    return cwise_median(x).to(x.dtype)

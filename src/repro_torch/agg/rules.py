"""Plain PyTorch aggregation rules — the part of ``repro.agg.rules`` that
serving needs: the sorting network, the coordinate-wise median and the
plurality vote, each with its masked (delivered-subset) variant.

Flat rules take a stack ``x`` of shape ``[n, ...]``. The ``masked_*``
variants aggregate the delivered subset of a boolean ``[n]`` mask that stays
a tensor (no host round trip), with the same sort tricks as the JAX package.
"""
from __future__ import annotations

import torch

# the sorting network lives with the median kernel's plain version
from ..kernels.cwise_median.ref import (  # noqa: F401
    _BIG, _oddeven_pairs, median_stack, sort_stack)


# ---------------------------------------------------------------------------
# coordinate-wise rules
# ---------------------------------------------------------------------------


def coordinate_median(x: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median ("Median" in the paper). [n, ...] -> [...]."""
    return median_stack(x)


def masked_coordinate_median(x: torch.Tensor, delivered) -> torch.Tensor:
    """Median over the delivered subset only. [n, ...], [n] -> [...].

    Undelivered entries are pushed to ``_BIG`` so the delivered ones sort
    first; the two middle delivered ranks are then read by index."""
    delivered = torch.as_tensor(delivered, dtype=torch.bool, device=x.device)
    q = delivered.sum()
    mask = delivered.reshape((-1,) + (1,) * (x.ndim - 1))
    xs = sort_stack(torch.where(mask, x, _BIG))
    lo = torch.div(q - 1, 2, rounding_mode="floor").reshape(1)
    hi = torch.div(q, 2, rounding_mode="floor").reshape(1)
    return 0.5 * (xs.index_select(0, lo)[0] + xs.index_select(0, hi)[0])


def vote(x: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise plurality vote: per coordinate, the value held by the
    most inputs (ties break toward the lowest input index). [n, ...] -> [...].
    Exact on any dtype: the answer is always one of the inputs."""
    eq = x[None, ...] == x[:, None, ...]            # [n, n, ...] pairwise
    counts = eq.sum(dim=1)                          # [n, ...]
    win = torch.argmax(counts, dim=0)               # first max
    return torch.gather(x, 0, win[None, ...])[0]


def masked_vote(x: torch.Tensor, delivered) -> torch.Tensor:
    """Plurality vote over the delivered subset only: pairs are counted only
    between delivered inputs and undelivered rows get count -1, so the
    winner is exactly ``vote(x[delivered])``."""
    m = torch.as_tensor(delivered, dtype=torch.bool, device=x.device)
    shape = (-1,) + (1,) * (x.ndim - 1)
    pair = (m[:, None] & m[None, :]).reshape(tuple(m.shape) * 2
                                             + (1,) * (x.ndim - 1))
    eq = (x[None, ...] == x[:, None, ...]) & pair
    counts = torch.where(m.reshape(shape), eq.sum(dim=1), -1)
    win = torch.argmax(counts, dim=0)
    return torch.gather(x, 0, win[None, ...])[0]

"""Plain PyTorch pieces of the coordinate-wise median: the sorting network
the kernel's plain version runs, the ``_BIG`` sentinel, and the test
oracle. :mod:`repro_torch.agg.rules` takes the network from here, so the
kernel package imports nothing above it."""
from __future__ import annotations

from functools import lru_cache

import torch

_BIG = 3.4e38                  # sorts after every real value, stays finite
_NETWORK_MAX_N = 32


@lru_cache(maxsize=None)
def _oddeven_pairs(n: int) -> tuple[tuple[int, int], ...]:
    """Batcher odd-even merge-sort compare-exchange schedule for arbitrary n."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return tuple(pairs)


def sort_stack(x: torch.Tensor) -> torch.Tensor:
    """``sort(x, dim=0)`` values for a small stack, as a compare-exchange
    network of elementwise min/max over rows (``torch.sort``, which orders
    NaN last, beyond n = 32). Before the network NaN maps to the finite
    ``_BIG``, so NaN payloads sort last instead of smearing through the
    min/max."""
    n = x.shape[0]
    if n <= 1:
        return x
    if n > _NETWORK_MAX_N:
        return torch.sort(x, dim=0).values
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), _BIG, x)
    rows = list(x.unbind(0))
    for i, j in _oddeven_pairs(n):
        a, b = rows[i], rows[j]
        rows[i] = torch.minimum(a, b)
        rows[j] = torch.maximum(a, b)
    return torch.stack(rows, dim=0)


def median_stack(x: torch.Tensor) -> torch.Tensor:
    """Median over dim 0 via :func:`sort_stack` (row n//2 for odd n)."""
    n = x.shape[0]
    xs = sort_stack(x)
    if n % 2:
        return xs[n // 2]
    return 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def cwise_median_ref(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median(x, axis=0)`` on NaN-free stacks: sort, then the mean of
    the two middle values (one value for odd n)."""
    n = x.shape[0]
    xs = torch.sort(x.float(), dim=0).values
    return 0.5 * (xs[(n - 1) // 2] + xs[n // 2])

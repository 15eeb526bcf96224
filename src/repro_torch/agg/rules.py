"""Plain PyTorch aggregation rules — the port of ``repro.agg.rules``.

Flat rules take a stack ``x`` of shape ``[n, ...]`` with a declared number of
Byzantine inputs ``f``; a rule that ignores ``f`` does not take it. The
``masked_*`` variants aggregate the delivered subset of a boolean ``[n]``
mask that stays a tensor (no host round trip), with the same sort tricks as
the JAX package. The distance-level helpers (``*_weights_from_d2``,
``mda_selection``, the Krum scores) also take a batch of distance matrices
``[B, n, n]`` (one per receiver), so a simulator step selects for every
receiver at once.

The paper's rules: MDA (Minimum-Diameter Averaging), the coordinate-wise
Median and MeaMed. Baselines: Krum, Multi-Krum, Bulyan, the trimmed mean and
the plain mean.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# the sorting network lives with the median kernel's plain version, the
# Gram-to-distance step with the Gram kernel's
from ..kernels.cwise_median.ref import (  # noqa: F401
    _BIG, _oddeven_pairs, median_stack, sort_stack)
from ..kernels.pairwise_sqdist.ref import sqdists_from_gram  # noqa: F401
# the subset enumeration lives with the selection kernel
from ..kernels.mda_diameter.ops import n_subsets, subset_masks  # noqa: F401

_LATE = 1e30      # "selectable, but after all delivered" score

# ---------------------------------------------------------------------------
# distances
# ---------------------------------------------------------------------------


def pairwise_sqdists(x: torch.Tensor) -> torch.Tensor:
    """Exact pairwise squared L2 distances via the Gram matrix.
    ``[.., n, d] -> [.., n, n]``."""
    x = x.float()
    sq = torch.sum(x * x, dim=-1)
    gram = x @ x.mT
    d2 = (sq[..., :, None] + sq[..., None, :]) - 2.0 * gram
    return torch.maximum(d2, torch.zeros_like(d2))


# ---------------------------------------------------------------------------
# MDA — Minimum-Diameter Averaging (the paper's worker-side GAR)
# ---------------------------------------------------------------------------


def subset_diameters(d2: torch.Tensor, masks) -> torch.Tensor:
    """Max in-subset squared distance for each subset mask.
    ``[.., n, n], [S, n] -> [.., S]``."""
    m = torch.as_tensor(np.asarray(masks, bool) if not isinstance(
        masks, torch.Tensor) else masks, device=d2.device)
    pair = m[:, :, None] & m[:, None, :]
    return torch.amax(torch.where(pair, d2[..., None, :, :], -torch.inf),
                      dim=(-2, -1))


def mda_select_exact(d2: torch.Tensor, f: int, *,
                     diameters_fn=subset_diameters) -> torch.Tensor:
    """Exact minimum-diameter subset -> bool mask ``[.., n]``: the first
    minimum in enumeration order. ``diameters_fn`` lets the dispatch layer
    substitute the subset-diameter kernel while the enumeration stays
    here."""
    n = d2.shape[-1]
    masks = subset_masks(n, f)
    diam = diameters_fn(d2, masks)
    best = torch.argmin(diam, dim=-1)
    return torch.as_tensor(masks, device=d2.device)[best]


def _set(sel: torch.Tensor, idx: torch.Tensor, value=True) -> torch.Tensor:
    return sel.scatter(-1, idx[..., None], value)


def mda_select_greedy(d2: torch.Tensor, f: int) -> torch.Tensor:
    """Greedy 2-approximation of the min-diameter subset -> bool ``[.., n]``.

    Seeds with the closest pair, then repeatedly adds the vector whose
    inclusion minimises the resulting diameter."""
    n = d2.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=d2.device)
    d2m = torch.where(eye, torch.inf, d2)
    ij = torch.argmin(d2m.flatten(-2), dim=-1)
    i, j = ij // n, ij % n
    sel = torch.zeros(d2.shape[:-1], dtype=torch.bool, device=d2.device)
    sel = _set(_set(sel, i), j)
    for _ in range(n - f - 2):
        dist_to_sel = torch.amax(
            torch.where(sel[..., None, :], d2, -torch.inf), dim=-1)
        cand = torch.where(sel, torch.inf, dist_to_sel)
        sel = _set(sel, torch.argmin(cand, dim=-1))
    return sel


def mda_select_greedy_masked(d2: torch.Tensor, f: int,
                             delivered) -> torch.Tensor:
    """Greedy min-diameter selection restricted to a delivered subset.

    Returns float32 weights ``[n]`` summing to 1 over the selected q-f
    delivered vectors. The greedy order visits every delivered vector before
    any non-delivered one, and the selection keeps the first q - f additions
    — with a full mask this reproduces :func:`mda_select_greedy`."""
    n = d2.shape[-1]
    delivered = torch.as_tensor(delivered, device=d2.device).bool()
    q = delivered.sum()
    pair_ok = delivered[:, None] & delivered[None, :]
    eye = torch.eye(n, dtype=torch.bool, device=d2.device)
    d2d = torch.where(pair_ok, d2, _LATE)
    ij = torch.argmin(torch.where(eye, torch.inf, d2d))
    i, j = ij // n, ij % n
    sel = torch.zeros(n, dtype=torch.bool, device=d2.device)
    sel[i] = True
    sel[j] = True
    order = torch.full((n,), n, dtype=torch.int64, device=d2.device)
    order[i] = 0
    order[j] = 1
    for s in range(2, n):
        dist_to_sel = torch.amax(torch.where(sel[None, :], d2d, -torch.inf),
                                 dim=1)
        cand = torch.where(sel, torch.inf, dist_to_sel)
        k = torch.argmin(cand)
        sel[k] = True
        order[k] = s
    keep = torch.clamp(q - f, min=1)
    sel = (order < keep) & delivered
    return sel.float() / torch.clamp(sel.sum(), min=1)


def mda(x: torch.Tensor, f: int, *, exact_limit: int = 200_000,
        d2: torch.Tensor | None = None) -> torch.Tensor:
    """Minimum-Diameter Averaging. ``[n, d] -> [d]``: the average of the
    size-(n-f) subset with minimal L2 diameter (exact when the subset count
    is tractable, greedy otherwise)."""
    n = x.shape[0]
    if n < 2 * f + 1:
        raise ValueError(f"MDA needs n >= 2f+1 (n={n}, f={f})")
    if f == 0:
        return torch.mean(x, dim=0)
    if d2 is None:
        d2 = pairwise_sqdists(x)
    if n_subsets(n, f) <= exact_limit:
        sel = mda_select_exact(d2, f)
    else:
        sel = mda_select_greedy(d2, f)
    w = sel.to(x.dtype) / (n - f)
    return w @ x


def mda_selection(d2: torch.Tensor, f: int, *, exact_limit: int = 200_000,
                  diameters_fn=subset_diameters) -> torch.Tensor:
    """Subset mask only, ``[.., n]`` bool."""
    n = d2.shape[-1]
    if f == 0:
        return torch.ones(d2.shape[:-1], dtype=torch.bool, device=d2.device)
    if n_subsets(n, f) <= exact_limit:
        return mda_select_exact(d2, f, diameters_fn=diameters_fn)
    return mda_select_greedy(d2, f)


def mda_weights_from_d2(d2: torch.Tensor, f: int, *, mask=None,
                        exact_limit: int = 200_000,
                        diameters_fn=subset_diameters) -> torch.Tensor:
    """``[.., n, n]`` distances -> ``[.., n]`` float32 averaging weights. With
    a ``mask``, selection is restricted to delivered senders via the greedy
    scan."""
    n = d2.shape[-1]
    if mask is not None:
        return mda_select_greedy_masked(d2, f, mask)
    sel = mda_selection(d2, f, exact_limit=exact_limit,
                        diameters_fn=diameters_fn)
    return sel.float() / (n - f if f else n)


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


def mean(x: torch.Tensor) -> torch.Tensor:
    """Vanilla averaging (not Byzantine resilient — the paper's strawman)."""
    return torch.mean(x, dim=0)


def masked_mean(x: torch.Tensor, delivered) -> torch.Tensor:
    """Mean of the delivered subset. [n, ...], [n] -> [...]."""
    w = torch.as_tensor(delivered, device=x.device).float()
    shape = (-1,) + (1,) * (x.ndim - 1)
    num = torch.sum(x.float() * w.reshape(shape), dim=0)
    return (num / torch.clamp(w.sum(), min=1.0)).to(x.dtype)


def trimmed_mean(x: torch.Tensor, f: int) -> torch.Tensor:
    """Coordinate-wise trimmed mean: drop the f lowest and f highest."""
    n = x.shape[0]
    if n <= 2 * f:
        raise ValueError("trimmed_mean needs n > 2f")
    xs = sort_stack(x)
    return torch.mean(xs[f:n - f], dim=0)


def masked_trimmed_mean(x: torch.Tensor, f: int, delivered) -> torch.Tensor:
    """Trimmed mean over the delivered subset: drop the f lowest and f
    highest of the q delivered values per coordinate."""
    n = x.shape[0]
    delivered = torch.as_tensor(delivered, dtype=torch.bool, device=x.device)
    q = delivered.sum()
    shape = (-1,) + (1,) * (x.ndim - 1)
    xs = sort_stack(torch.where(delivered.reshape(shape), x, _BIG))
    rank = torch.arange(n, device=x.device).reshape(shape)
    keep = (rank >= f) & (rank < q - f)
    num = torch.sum(torch.where(keep, xs.float(), 0.0), dim=0)
    return (num / torch.clamp(q - 2 * f, min=1)).to(x.dtype)


def meamed(x: torch.Tensor, f: int) -> torch.Tensor:
    """Mean-around-Median (Xie et al. 2018): per coordinate, the mean of the
    n-f values closest to the coordinate median (stable argsort: ties go to
    the lower input index). The kernel and its plain version scan sorted
    windows instead; the two differ only on exact ties."""
    n = x.shape[0]
    med = median_stack(x)[None]
    dist = torch.abs(x - med)
    idx = torch.argsort(dist, dim=0, stable=True)[:n - f]
    return torch.mean(torch.gather(x, 0, idx), dim=0)


def masked_meamed(x: torch.Tensor, f: int, delivered) -> torch.Tensor:
    """Mean-around-Median over the delivered subset: per coordinate, the
    mean of the q-f delivered values closest to the delivered median."""
    n = x.shape[0]
    delivered = torch.as_tensor(delivered, dtype=torch.bool, device=x.device)
    q = delivered.sum()
    shape = (-1,) + (1,) * (x.ndim - 1)
    med = masked_coordinate_median(x, delivered)[None]
    dist = torch.where(delivered.reshape(shape), torch.abs(x - med), _BIG)
    order = torch.argsort(dist, dim=0, stable=True)      # delivered first
    vals = torch.gather(x, 0, order)
    rank = torch.arange(n, device=x.device).reshape(shape)
    keep = rank < torch.clamp(q - f, min=1)
    num = torch.sum(torch.where(keep, vals.float(), 0.0), dim=0)
    return (num / torch.clamp(q - f, min=1)).to(x.dtype)


# ---------------------------------------------------------------------------
# Krum family (baselines)
# ---------------------------------------------------------------------------


def _krum_scores(d2: torch.Tensor, f: int) -> torch.Tensor:
    """Krum score: the sum of the n-f-2 smallest squared distances to
    neighbours. ``[.., n, n] -> [.., n]``."""
    n = d2.shape[-1]
    m = n - f - 2
    if m < 1:
        raise ValueError(f"Krum needs n >= f+3 (n={n}, f={f})")
    eye = torch.eye(n, dtype=torch.bool, device=d2.device)
    srt = torch.sort(torch.where(eye, torch.inf, d2), dim=-1).values
    return torch.sum(srt[..., :m], dim=-1)


def _krum_scores_masked(d2: torch.Tensor, f: int, delivered) -> torch.Tensor:
    """Krum scores over the delivered subset: each delivered vector scores
    the sum of its q-f-2 smallest distances to delivered neighbours;
    non-delivered vectors score +inf."""
    n = d2.shape[-1]
    delivered = torch.as_tensor(delivered, device=d2.device).bool()
    q = delivered.sum()
    eye = torch.eye(n, dtype=torch.bool, device=d2.device)
    ok = delivered[:, None] & delivered[None, :] & ~eye
    srt = torch.sort(torch.where(ok, d2, torch.inf), dim=1).values
    m = torch.clamp(q - f - 2, min=1)
    keep = torch.arange(n, device=d2.device)[None, :] < m
    scores = torch.sum(torch.where(keep & torch.isfinite(srt), srt, 0.0),
                       dim=1)
    return torch.where(delivered, scores, torch.inf)


def krum_weights_from_d2(d2: torch.Tensor, f: int, *,
                         mask=None) -> torch.Tensor:
    """One-hot ``[.., n]`` float32 weights on the best-scored vector."""
    scores = (_krum_scores(d2, f) if mask is None
              else _krum_scores_masked(d2, f, mask))
    return torch.nn.functional.one_hot(torch.argmin(scores, dim=-1),
                                       d2.shape[-1]).float()


def multi_krum_weights_from_d2(d2: torch.Tensor, f: int, *, mask=None,
                               m: int | None = None) -> torch.Tensor:
    """``[.., n]`` float32 averaging weights over the m best-scored vectors
    (default m = n - f, or q - f under a delivery mask)."""
    n = d2.shape[-1]
    if mask is None:
        scores = _krum_scores(d2, f)
        mm = n - f if m is None else m
        idx = torch.argsort(scores, dim=-1, stable=True)[..., :mm]
        sel = torch.zeros(scores.shape, dtype=torch.bool,
                          device=d2.device).scatter(-1, idx, True)
    else:
        scores = _krum_scores_masked(d2, f, mask)
        q = torch.as_tensor(mask, device=d2.device).long().sum()
        mm = torch.clamp(q - f, min=1) if m is None else m
        rank = torch.argsort(torch.argsort(scores, stable=True), stable=True)
        sel = rank < mm
    return sel.float() / torch.clamp(sel.sum(dim=-1, keepdim=True), min=1)


def krum(x: torch.Tensor, f: int) -> torch.Tensor:
    """Krum (Blanchard et al. 2017): the single vector with the best
    score."""
    scores = _krum_scores(pairwise_sqdists(x), f)
    return x[torch.argmin(scores)]


def multi_krum(x: torch.Tensor, f: int, m: int | None = None) -> torch.Tensor:
    """Multi-Krum: average of the m best-scored vectors (default m = n-f)."""
    n = x.shape[0]
    m = n - f if m is None else m
    scores = _krum_scores(pairwise_sqdists(x), f)
    idx = torch.argsort(scores, stable=True)[:m]
    return torch.mean(x[idx], dim=0)


def _median_sorted(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median(x, axis=0)``: the midpoint of the two middle sorted
    values, NaN wherever a column holds one."""
    k = x.shape[0]
    xs = torch.sort(x, dim=0).values
    med = 0.5 * (xs[(k - 1) // 2] + xs[k // 2])
    return torch.where(torch.isnan(x).any(dim=0), torch.nan, med)


def bulyan(x: torch.Tensor, f: int) -> torch.Tensor:
    """Bulyan (El Mhamdi et al. 2018): n-2f rounds of Krum selection, then
    coordinate-wise trimmed aggregation around the median. Needs
    n >= 4f+3."""
    n = x.shape[0]
    theta = n - 2 * f
    if theta < 1:
        raise ValueError(f"Bulyan needs n >= 4f+3 (n={n}, f={f})")
    d2 = pairwise_sqdists(x)
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    alive = torch.ones(n, dtype=torch.bool, device=x.device)
    picks = []
    for _ in range(theta):
        d2a = torch.where(alive[None, :] & alive[:, None] & ~eye, d2,
                          torch.inf)
        srt = torch.sort(d2a, dim=1).values
        m = max(n - f - 2, 1)
        scores = torch.sum(torch.where(torch.isinf(srt[:, :m]), 0.0,
                                       srt[:, :m]), dim=1)
        scores = torch.where(alive, scores, torch.inf)
        k = torch.argmin(scores)
        picks.append(x[k])
        alive = alive.clone()
        alive[k] = False
    sel = torch.stack(picks)
    beta = theta - 2 * f
    med = _median_sorted(sel)[None]
    idx = torch.argsort(torch.abs(sel - med), dim=0,
                        stable=True)[:max(beta, 1)]
    return torch.mean(torch.gather(sel, 0, idx), dim=0)


# ---------------------------------------------------------------------------
# variance-to-norm bounds (Appendix D / Fig. 7)
# ---------------------------------------------------------------------------


def mda_variance_threshold(n: int, f: int) -> float:
    """Eq. (3)/(7): MDA is safe while stddev/||grad|| <= (n-f) / (2f)."""
    return float(n - f) / (2.0 * f) if f > 0 else float("inf")


def krum_variance_threshold(n: int, f: int) -> float:
    """Blanchard et al. 2017: the usable stddev/norm ratio is 1/eta with
    eta(n,f) = sqrt(2 (n - f + f(n-f-2) + f^2 (n-f-1) / (n-2f-2)))."""
    if f == 0:
        return float("inf")
    if n - 2 * f - 2 <= 0:
        return 0.0
    eta2 = 2.0 * (n - f + (f * (n - f - 2) + f * f * (n - f - 1))
                  / (n - 2 * f - 2))
    return 1.0 / math.sqrt(eta2)

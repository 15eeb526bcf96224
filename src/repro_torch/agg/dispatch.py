"""Dispatch: route each aggregation primitive to its kernel or its plain
version.

Three kernel packages serve the rules: ``pairwise_sqdist`` (the Gram kernel,
under every distance-based rule), ``mda_diameter`` (exact MDA's selection:
the subset diameters, their first argmin and the weights) and
``cwise_median`` (median, trimmed mean and MeaMed). The route is the device
of the tensor and the stack size, with no option and no fallback:

  * a CUDA stack with n <= 64 launches the kernel;
  * a CPU stack with n <= 64 runs the kernel wrapper's plain version;
  * a stack with n > 64 runs the plain rule of :mod:`rules`, as the JAX
    package does beyond its kernels' limit.

A stack ``[n, ...]`` is viewed as ``[n, prod(rest)]``: a coordinate-wise rule
over ``[R, slots, V]`` is the rule over ``[R, slots * V]``, so every call runs
one kernel (the JAX dispatch sends only 2-D stacks to its Pallas kernels
because of a BlockSpec limit, not the rules' meaning). With ``batched=True``
the stack is ``[B, n, ...]``: B receivers, one launch for all of them.
"""
from __future__ import annotations

import torch

from ..device import card_route
from ..kernels import work
from ..kernels.cwise_median import ops as order_ops
from ..kernels.mda_diameter import ops as diam_ops
from ..kernels.pairwise_sqdist import ops as gram_ops
from ..kernels.pairwise_sqdist.ref import gram_ref
from . import rules

MAX_N = 64


def _flat(x: torch.Tensor, batched: bool):
    """``(x viewed as [B, n, d] or [n, d], n, out shape)``."""
    if batched:
        B, n = x.shape[:2]
        return x.reshape(B, n, -1), n, (B,) + tuple(x.shape[2:])
    n = x.shape[0]
    return x.reshape(n, -1), n, tuple(x.shape[1:])


def _per_receiver(fn, x: torch.Tensor, *args):
    """A plain rule over ``[n, ...]`` applied to each stack of a batch."""
    return torch.stack([fn(xb, *args) for xb in x])


def gram(x: torch.Tensor) -> torch.Tensor:
    """``[.., n, d] -> [.., n, n]`` float32 Gram (at most one leading batch
    dim on the kernel route)."""
    if x.shape[-2] > MAX_N:
        return gram_ref(x)
    return gram_ops.gram(x)


def pairwise_sqdists(x: torch.Tensor) -> torch.Tensor:
    """``[.., n, d] -> [.., n, n]`` exact squared L2 distances."""
    if x.shape[-2] > MAX_N:
        return rules.pairwise_sqdists(x)
    return gram_ops.pairwise_sqdists(x)


def subset_diameters(d2: torch.Tensor, masks) -> torch.Tensor:
    """``[.., n, n]`` distances + ``[S, n]`` subset masks -> ``[.., S]``."""
    if d2.shape[-1] > MAX_N:
        return rules.subset_diameters(d2, masks)
    return diam_ops.subset_diameters(d2, masks)


def cwise_median(x: torch.Tensor, *, batched: bool = False) -> torch.Tensor:
    """``[n, ...] -> [...]`` (or ``[B, n, ...] -> [B, ...]``) float32
    coordinate-wise median."""
    x2, n, shape = _flat(x, batched)
    if n > MAX_N:
        fn = rules.coordinate_median
        out = _per_receiver(fn, x2.float()) if batched else fn(x2.float())
    else:
        out = order_ops.cwise_median(x2)
    return out.reshape(shape)


def median(x: torch.Tensor, *, batched: bool = False) -> torch.Tensor:
    """Coordinate-wise median through the dispatch, in the input's dtype."""
    return cwise_median(x, batched=batched).to(x.dtype)


def _cwise_rule(x, f, kernel_fn, rule_fn, batched):
    x2, n, shape = _flat(x, batched)
    if n > MAX_N:
        out = (_per_receiver(rule_fn, x2, f) if batched else rule_fn(x2, f))
    else:
        out = kernel_fn(x2, f)
    return out.reshape(shape).to(x.dtype)


def trimmed_mean(x: torch.Tensor, f: int, *,
                 batched: bool = False) -> torch.Tensor:
    """Coordinate-wise trimmed mean through the dispatch."""
    return _cwise_rule(x, f, order_ops.cwise_trimmed_mean,
                       rules.trimmed_mean, batched)


def meamed(x: torch.Tensor, f: int, *, batched: bool = False) -> torch.Tensor:
    """Mean-around-Median through the dispatch. The kernel (and its plain
    version) keep the Pallas kernel's window scan and tie contract; the
    plain rule past n = 64 keeps the JAX reference's argsort. They differ
    only when two values sit exactly equidistant from the median."""
    return _cwise_rule(x, f, order_ops.cwise_meamed, rules.meamed, batched)


def mda_weights_from_d2(d2: torch.Tensor, f: int, *, mask=None,
                        exact_limit: int = 200_000) -> torch.Tensor:
    """``rules.mda_weights_from_d2``. On a CUDA or a meta tensor
    (:func:`~repro_torch.device.card_route`) the exact selection
    (no mask, f > 0, n <= 64, at most ``exact_limit`` subsets) is one launch
    of the selection kernel, which returns the weights (on a CPU tensor
    too while a work counter counts, so a CPU step is counted as the
    card's: :mod:`repro_torch.kernels.work`); every other route runs the
    rules with the subset-diameter wrapper."""
    n = d2.shape[-1]
    if ((card_route(d2) or work.counting()) and mask is None
            and 0 < f < n and n <= MAX_N
            and rules.n_subsets(n, f) <= exact_limit):
        w = diam_ops.mda_select(d2.reshape(-1, n, n), f)[1]
        return w.reshape(d2.shape[:-1])
    return rules.mda_weights_from_d2(d2, f, mask=mask,
                                     exact_limit=exact_limit,
                                     diameters_fn=subset_diameters)


def _combine(w: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """``[.., n]`` weights x ``[.., n, d]`` stack -> ``[.., d]`` float32."""
    return torch.matmul(w[..., None, :], x2.float())[..., 0, :]


def mda(x: torch.Tensor, f: int, *, exact_limit: int = 200_000,
        batched: bool = False) -> torch.Tensor:
    """Minimum-Diameter Averaging: the Gram and (when exact) the subset
    diameters run on their kernels; the selection logic stays in
    :mod:`rules`."""
    x2, n, shape = _flat(x, batched)
    if n < 2 * f + 1:
        raise ValueError(f"MDA needs n >= 2f+1 (n={n}, f={f})")
    if f == 0:
        return torch.mean(x2, dim=-2).reshape(shape)
    w = mda_weights_from_d2(pairwise_sqdists(x2), f, exact_limit=exact_limit)
    return _combine(w, x2).reshape(shape).to(x.dtype)


def krum(x: torch.Tensor, f: int, *, batched: bool = False) -> torch.Tensor:
    """Krum with the distance step on the Gram kernel."""
    x2, _, shape = _flat(x, batched)
    w = rules.krum_weights_from_d2(pairwise_sqdists(x2), f)
    return _combine(w, x2).reshape(shape).to(x.dtype)


def multi_krum(x: torch.Tensor, f: int, *, m: int | None = None,
               batched: bool = False) -> torch.Tensor:
    """Multi-Krum with the distance step on the Gram kernel."""
    x2, _, shape = _flat(x, batched)
    w = rules.multi_krum_weights_from_d2(pairwise_sqdists(x2), f, m=m)
    return _combine(w, x2).reshape(shape).to(x.dtype)

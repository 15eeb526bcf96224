"""repro_torch.agg — the Aggregator API of ``repro.agg``, all nine rules:

    import repro_torch.agg as agg

    agg.get("mda")(x, f)                        # flat [n, ...] stack
    agg.get("median")(x, f, mask=delivered)     # delivered subset
    agg.tree_agg("mda", stack, f)               # [n, D] or [B, n, D] stack
    agg.aggregate("krum", x, f)                 # functional spelling

The kernels route by device (:mod:`repro_torch.agg.dispatch`): a CUDA stack
of n <= 64 launches the kernel, a CPU stack runs its plain version.
"""
from __future__ import annotations

from . import dispatch, registry, rules, tree
from .dispatch import cwise_median, pairwise_sqdists, subset_diameters
from .registry import Aggregator, get, names, register, specs
from .tree import selection_weights, tree_agg, tree_gram


def aggregate(rule, x, f: int = 0, **kw):
    """Functional spelling of ``get(rule)(x, f, **kw)`` (``rule``: a name
    or an :class:`Aggregator`)."""
    spec = rule if isinstance(rule, Aggregator) else get(rule)
    return spec(x, f, **kw)


__all__ = ["Aggregator", "aggregate", "cwise_median", "dispatch", "get",
           "names",
           "pairwise_sqdists", "register", "registry", "rules",
           "selection_weights", "specs", "subset_diameters", "tree",
           "tree_agg", "tree_gram"]

"""repro_torch.agg — the Aggregator API of ``repro.agg`` for the rules the
port has so far (``median``, ``vote``):

    import repro_torch.agg as agg

    agg.get("median")(x, f)                    # [n, ...] stack
    agg.get("median")(x, f, mask=delivered)    # delivered subset

The median routes by device (:mod:`repro_torch.agg.dispatch`): the CUDA
kernel for a GPU stack, its plain version for a CPU one.
"""
from __future__ import annotations

from . import dispatch, registry, rules
from .dispatch import cwise_median
from .registry import Aggregator, get, names, register

__all__ = ["Aggregator", "cwise_median", "dispatch", "get", "names",
           "register", "registry", "rules"]

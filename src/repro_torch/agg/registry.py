"""The :class:`Aggregator` spec and the rule registry — the serving rules
(``median`` and ``vote``) of ``repro.agg.registry``, with the same names,
breakdown points and mask semantics.

A mask given on the host (numpy array, list) is concrete: the rule runs on
the delivered subset ``x[mask]`` after the count is validated, exactly as
the JAX package treats a concrete mask. A mask given as a tensor stays on
the device and goes to the rule's masked implementation (the JAX package's
path for a traced mask), so no host round trip is forced.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from . import dispatch, rules


@dataclass(frozen=True)
class Aggregator:
    """Spec + entry point for one aggregation rule.

    Calling the spec aggregates a flat stack: ``spec(x, f, mask=...)``.
    """
    name: str
    fn: Callable                     # reference callable, natural arity
    takes_f: bool                    # whether ``fn`` takes the declared f
    breakdown: str                   # human-readable resilience bound
    requires: tuple[int, int]        # enforced bound: n >= k*f + c
    doc: str = ""
    masked_fn: Callable | None = None   # (x, [f,] mask tensor) -> [...]

    def validate(self, n: int, f: int) -> None:
        """Uniform f-bounds check from the spec's mechanical requirement."""
        k, c = self.requires
        if f < 0:
            raise ValueError(f"aggregator {self.name!r}: f must be >= 0, got {f}")
        if f >= n:
            raise ValueError(
                f"aggregator {self.name!r}: need f < n, got n={n}, f={f}")
        if n < k * f + c:
            need = (f"{k}f+{c}" if k else f"{c}").replace("1f", "f")
            raise ValueError(
                f"aggregator {self.name!r} requires n >= {need} "
                f"(breakdown point {self.breakdown}): got n={n}, f={f}")

    def _call_unmasked(self, x, f):
        return self.fn(x, f) if self.takes_f else self.fn(x)

    def __call__(self, x: torch.Tensor, f: int = 0, *, mask=None):
        n = x.shape[0]
        self.validate(n, f)
        if mask is None:
            return self._call_unmasked(x, f)
        if not isinstance(mask, torch.Tensor):
            # host mask: exact subset semantics
            m = np.asarray(mask, bool)
            if m.shape != (n,):
                raise ValueError(f"mask must be [n={n}] bool, got {m.shape}")
            self.validate(int(m.sum()), f)
            if m.all():
                return self._call_unmasked(x, f)
            idx = torch.as_tensor(np.flatnonzero(m), device=x.device)
            return self._call_unmasked(x.index_select(0, idx), f)
        if self.masked_fn is None:
            raise ValueError(f"aggregator {self.name!r} has no masked "
                             f"implementation; pass a host mask")
        return (self.masked_fn(x, f, mask) if self.takes_f
                else self.masked_fn(x, mask))


_REGISTRY: dict[str, Aggregator] = {}


def register(spec: Aggregator) -> Aggregator:
    if spec.name in _REGISTRY:
        raise ValueError(f"aggregator {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> Aggregator:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown aggregator {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


def names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register(Aggregator(
    name="median", fn=dispatch.median, takes_f=False,
    breakdown="n >= 2f+1", requires=(2, 1),
    doc="coordinate-wise median (server-model DMC rule)",
    masked_fn=rules.masked_coordinate_median))

register(Aggregator(
    name="vote", fn=rules.vote, takes_f=False,
    breakdown="n >= 2f+1", requires=(2, 1),
    doc="coordinate-wise plurality vote (serve-quorum read rule for "
        "discrete outputs, e.g. argmax token ids)",
    masked_fn=rules.masked_vote))

"""The :class:`Aggregator` spec and the rule registry — the nine rules of
``repro.agg.registry`` with the same names, breakdown points, capability
flags, tunables and mask semantics.

A mask given on the host (numpy array, list) is concrete: the rule runs on
the delivered subset ``x[mask]`` after the count is validated, exactly as
the JAX package treats a concrete mask. A mask given as a tensor stays on
the device and goes to the rule's masked implementation (the JAX package's
path for a traced mask), so no host round trip is forced.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from . import dispatch, rules


@dataclass(frozen=True)
class Aggregator:
    """Spec + entry point for one aggregation rule.

    Calling the spec aggregates a flat stack: ``spec(x, f, mask=..., ...)``.
    ``batches`` says that ``fn`` also takes ``batched=True`` with a
    ``[B, n, ...]`` stack (one launch for B receivers). ``backends`` names
    the routes of ``fn`` (:mod:`.dispatch`): ``torch``, the plain PyTorch
    version (a CPU stack, or past the kernels' n), and ``cuda (...)``, the
    kernel packages a CUDA stack launches.
    """
    name: str
    fn: Callable                     # reference callable, natural arity
    takes_f: bool                    # whether ``fn`` takes the declared f
    breakdown: str                   # human-readable resilience bound
    requires: tuple[int, int]        # enforced bound: n >= k*f + c
    doc: str = ""
    variance_threshold: Callable[[int, int], float] | None = None
    selection_based: bool = False
    tree_mode: str | None = "leafwise"      # 'leafwise' | 'selection' | None
    masked_fn: Callable | None = None       # (x, [f,] mask tensor) -> [...]
    weights_from_d2: Callable | None = None  # (d2, f, *, mask=None, **kw)
    tunables: frozenset[str] = frozenset()  # extra kwargs the rule accepts
    batches: bool = False
    backends: tuple[str, ...] = ("torch",)

    @property
    def supports_masked_delivery(self) -> bool:
        return self.masked_fn is not None or (
            self.selection_based and self.weights_from_d2 is not None)

    @property
    def is_sanitizer(self) -> bool:
        """Whether the rule launders Byzantine influence: a nonzero
        breakdown point (``n >= k*f + c`` with ``k >= 2``). ``mean`` is
        not one."""
        return self.requires[0] >= 2

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

    def filter_kwargs(self, **kw) -> dict[str, Any]:
        """Keep only the kwargs this rule accepts."""
        return {k: v for k, v in kw.items() if k in self.tunables}

    def _call_unmasked(self, x, f, *, batched: bool = False, **kw):
        kw = self.filter_kwargs(**kw)
        if batched:
            kw["batched"] = True
        return self.fn(x, f, **kw) if self.takes_f else self.fn(x, **kw)

    def __call__(self, x: torch.Tensor, f: int = 0, *, mask=None, **kw):
        n = x.shape[0]
        self.validate(n, f)
        if mask is None:
            return self._call_unmasked(x, f, **kw)
        if not isinstance(mask, torch.Tensor):
            # host mask: exact subset semantics for every rule
            m = np.asarray(mask, bool)
            if m.shape != (n,):
                raise ValueError(f"mask must be [n={n}] bool, got {m.shape}")
            self.validate(int(m.sum()), f)
            if m.all():
                return self._call_unmasked(x, f, **kw)
            idx = torch.as_tensor(np.flatnonzero(m), device=x.device)
            return self._call_unmasked(x.index_select(0, idx), f, **kw)
        if not self.supports_masked_delivery:
            raise ValueError(
                f"aggregator {self.name!r} has no tensor-mask implementation; "
                f"pass a host mask or use one of "
                f"{sorted(k for k, s in _REGISTRY.items() if s.supports_masked_delivery)}")
        if self.masked_fn is not None:
            return (self.masked_fn(x, f, mask) if self.takes_f
                    else self.masked_fn(x, mask))
        # selection-based: d2 -> masked weights -> convex combination
        d2 = dispatch.pairwise_sqdists(x.reshape(n, -1))
        w = self.weights_from_d2(d2, f, mask=mask, **self.filter_kwargs(**kw))
        return (w @ x.reshape(n, -1).float()).reshape(x.shape[1:]).to(x.dtype)


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


def specs() -> tuple[Aggregator, ...]:
    return tuple(_REGISTRY[n] for n in names())


#: the routes of the dispatch-level rules: the kernel packages under each
_CUDA_GRAM = "cuda (pairwise_sqdist)"
_CUDA_MDA = "cuda (pairwise_sqdist + mda_diameter)"
_CUDA_ORDER = "cuda (cwise_median)"


# ---------------------------------------------------------------------------
# built-in rules
# ---------------------------------------------------------------------------

register(Aggregator(
    name="mda", fn=dispatch.mda, takes_f=True,
    breakdown="n >= 2f+1", requires=(2, 1),
    doc="Minimum-Diameter Averaging (the paper's worker-gradient GAR)",
    variance_threshold=rules.mda_variance_threshold,
    selection_based=True, tree_mode="selection",
    weights_from_d2=dispatch.mda_weights_from_d2,
    tunables=frozenset({"exact_limit"}), batches=True,
    backends=("torch", _CUDA_MDA)))

register(Aggregator(
    name="median", fn=dispatch.median, takes_f=False,
    breakdown="n >= 2f+1", requires=(2, 1),
    doc="coordinate-wise median (server-model DMC rule)",
    masked_fn=rules.masked_coordinate_median, batches=True,
    backends=("torch", _CUDA_ORDER)))

register(Aggregator(
    name="meamed", fn=dispatch.meamed, takes_f=True,
    breakdown="n >= 2f+1", requires=(2, 1),
    doc="mean-around-median (sync worker gather rule)",
    masked_fn=rules.masked_meamed, batches=True,
    backends=("torch", _CUDA_ORDER)))

register(Aggregator(
    name="trimmed_mean", fn=dispatch.trimmed_mean, takes_f=True,
    breakdown="n >= 2f+1", requires=(2, 1),
    doc="coordinate-wise trimmed mean (baseline)",
    masked_fn=rules.masked_trimmed_mean, batches=True,
    backends=("torch", _CUDA_ORDER)))

register(Aggregator(
    name="krum", fn=dispatch.krum, takes_f=True,
    breakdown="n >= 2f+3", requires=(2, 3),
    doc="Krum (Blanchard et al. 2017) — single best-scored vector",
    variance_threshold=rules.krum_variance_threshold,
    selection_based=True, tree_mode="selection",
    weights_from_d2=rules.krum_weights_from_d2, batches=True,
    backends=("torch", _CUDA_GRAM)))

register(Aggregator(
    name="multi_krum", fn=dispatch.multi_krum, takes_f=True,
    breakdown="n >= 2f+3", requires=(2, 3),
    doc="Multi-Krum — average of the m best-scored vectors",
    variance_threshold=rules.krum_variance_threshold,
    selection_based=True, tree_mode="selection",
    weights_from_d2=rules.multi_krum_weights_from_d2,
    tunables=frozenset({"m"}), batches=True,
    backends=("torch", _CUDA_GRAM)))

register(Aggregator(
    name="bulyan", fn=rules.bulyan, takes_f=True,
    breakdown="n >= 4f+3", requires=(4, 3),
    doc="Bulyan — recursive Krum + trimmed aggregation (baseline)",
    tree_mode=None))

register(Aggregator(
    name="vote", fn=rules.vote, takes_f=False,
    breakdown="n >= 2f+1", requires=(2, 1),
    doc="coordinate-wise plurality vote (serve-quorum read rule for "
        "discrete outputs, e.g. argmax token ids)",
    masked_fn=rules.masked_vote))

register(Aggregator(
    name="mean", fn=rules.mean, takes_f=False,
    breakdown="none (f = 0 only)", requires=(0, 1),
    doc="plain averaging (the paper's non-resilient strawman)",
    masked_fn=rules.masked_mean))


# ---------------------------------------------------------------------------
# registry-derived documentation (``python -m repro_torch.agg``)
# ---------------------------------------------------------------------------


def markdown_table(n: int = 18, f: int = 2) -> str:
    """The aggregator table, derived from the registry as the JAX package
    derives its own; the ``backends`` column names the port's routes."""
    head = ("| rule | breakdown point | variance threshold (n=%d, f=%d) | "
            "backends | masked delivery | pytree |" % (n, f))
    sep = "|---|---|---|---|---|---|"
    out = [head, sep]
    for s in specs():
        if s.variance_threshold is None:
            vt = "—"
        else:
            v = s.variance_threshold(n, f)
            vt = "inf" if v == float("inf") else f"{v:.3f}"
        out.append(
            f"| `{s.name}` | {s.breakdown} | {vt} | {', '.join(s.backends)} | "
            f"{'yes' if s.supports_masked_delivery else 'concrete-only'} | "
            f"{s.tree_mode or '—'} |")
    return "\n".join(out)

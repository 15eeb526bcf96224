"""Named experiment presets — the eight single-host presets of
``repro.exp.presets``, identical specs (``to_dict``/``spec_hash``).

:func:`get` applies field overrides with ``dataclasses.replace``
(re-validating). The netsim, serve, elastic and lm presets of the JAX
package need runners the port does not have yet (``ROADMAP.md``).
"""
from __future__ import annotations

from ..core.attacks import ByzantineSpec
from .spec import Experiment

_PRESETS: dict[str, Experiment] = {}


def register(exp: Experiment, *, replace: bool = False) -> Experiment:
    """Register a preset under ``exp.name``."""
    if exp.name in _PRESETS and not replace:
        raise ValueError(f"experiment preset {exp.name!r} already registered")
    _PRESETS[exp.name] = exp
    return exp


def get(name: str, **overrides) -> Experiment:
    """Preset by name, with field overrides applied (and re-validated)."""
    try:
        base = _PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown experiment preset {name!r}; "
                       f"have {sorted(_PRESETS)}") from None
    return base.replace(**overrides) if overrides else base


def names() -> tuple[str, ...]:
    return tuple(sorted(_PRESETS))


# the smoke spec: small enough to run in seconds, shaped to exercise a gather
# boundary and a tail (steps % T != 0)
register(Experiment(
    name="smoke", n_workers=5, f_workers=1, n_servers=5, f_servers=1, T=5,
    steps=12, batch=8, model="mlp_h32", data="mixture5_small",
    scenario="baseline_uniform", metrics_every=5, eval_n=256))

# clean baselines (Fig. 3): async and sync ByzSGD without adversaries
register(Experiment(name="clean_async", variant="async", steps=120))
register(Experiment(name="clean_sync", variant="sync", n_workers=5,
                    f_workers=1, steps=120))

# the quickstart: 2/9 workers mounting ALIE, converges anyway (§6 headline)
register(Experiment(
    name="quickstart", data="mixture10_easy",
    byz=ByzantineSpec(worker_attack="alie", n_byz_workers=2,
                      equivocate=True)))

# Fig. 6 operating point: max declared f_w, all of it actually Byzantine
register(Experiment(
    name="alie_workers", n_workers=13, f_workers=4, steps=120,
    byz=ByzantineSpec(worker_attack="alie", n_byz_workers=4,
                      equivocate=True)))

# Fig. 5 operating points: one Byzantine server
register(Experiment(
    name="lie_server", steps=120, track_delta=True,
    byz=ByzantineSpec(server_attack="lie", n_byz_servers=1,
                      equivocate=True)))
register(Experiment(
    name="reversed_server", steps=120, track_delta=True,
    byz=ByzantineSpec(server_attack="reversed", n_byz_servers=1,
                      equivocate=True)))

# sync filter variant under a Byzantine server (Fig. 10 operating point)
register(Experiment(
    name="sync_filters", variant="sync", n_workers=5, f_workers=1, T=20,
    steps=100, batch=100, lip_horizon=32, l2=3e-2, decay=0.001,
    byz=ByzantineSpec(server_attack="reversed", n_byz_servers=1,
                      equivocate=True)))

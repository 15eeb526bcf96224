"""Named experiment presets of ``repro.exp.presets``, identical specs
(``to_dict``/``spec_hash``): the eight single-host presets, the six netsim
presets, the two serve presets, the three elastic presets and the three lm
presets.

:func:`get` applies field overrides with ``dataclasses.replace``
(re-validating). The ``netsim/*`` presets name their scenario and the
matching threat model, with ``runner="netsim"``: :func:`repro_torch.exp.run`
simulates the cluster and trains over the realized trace. The three
``lm/*`` presets train a reduced dense transformer, MoE and RWKV6 through
the protocol. ``python -m repro_torch.exp`` prints the tables below.
"""
from __future__ import annotations

from ..core.attacks import ByzantineSpec
from ..core.membership import MembershipEvent, MembershipPlan
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


def specs() -> tuple[Experiment, ...]:
    return tuple(_PRESETS[n] for n in names())


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


# netsim presets: one per scenario factory, trained over the realized trace
_NETSIM_COMMON = dict(
    runner="netsim", T=5, steps=30, batch=16, model="mlp_h32",
    data="mixture5_small", metrics_every=10, eval_n=512)
for _scen in ("baseline_uniform", "heavy_tail_stragglers", "partitioned_dmc",
              "crash_storm", "membership_churn"):
    register(Experiment(name=f"netsim/{_scen}", scenario=_scen,
                        **_NETSIM_COMMON))
# the compound adversary: netsim makes the Byzantine workers slow, the
# simulator's injection makes them malicious (the factory's defaults)
register(Experiment(
    name="netsim/byzantine_plus_slow", scenario="byzantine_plus_slow",
    byz=ByzantineSpec(worker_attack="alie", n_byz_workers=2, equivocate=True),
    **_NETSIM_COMMON))

# serve presets: protocol-runner training that emits replica-stacked
# checkpoints for the serving path (ckpt_dir comes from the caller at run
# time: exp.run("serve/ckpt_smoke", ckpt_dir=...)). G=5 satisfies Table 1's
# n_ps >= 3f+2 for training; serving reads tolerate f=1 of any 2f+1 subset.
_SERVE_COMMON = dict(
    runner="protocol", n_workers=5, f_workers=1, n_servers=5, f_servers=1,
    T=5, steps=10, batch=8, model="mlp_h32", data="mixture5_small",
    metrics_every=5, eval_n=256, ckpt_every=5)
register(Experiment(name="serve/ckpt_smoke", **_SERVE_COMMON))
register(Experiment(
    name="serve/ckpt_lie_server",
    byz=ByzantineSpec(server_attack="lie", n_byz_servers=1, equivocate=True),
    **_SERVE_COMMON))

# elastic presets: join/leave-tolerant protocol training (core/membership).
# G=5 launches at the declared Table-1 point (f_w=f_ps=1); while a group is
# down (G'=4) the churn-driven resilience caps f_ps' at 0, so these presets
# have no Byzantine servers (such a spec with a shrink event is refused at
# construction with MembershipFloorError).
_ELASTIC_COMMON = dict(
    runner="elastic", n_workers=5, f_workers=1, n_servers=5, f_servers=1,
    T=5, steps=24, batch=8, model="mlp_h32", data="mixture5_small",
    metrics_every=4, eval_n=256)
# static fleet: bit-identical to runner="protocol" on the same spec
register(Experiment(name="elastic/static", **_ELASTIC_COMMON))
# authored plan: group 4 leaves at step 8 (G 5->4) and rejoins at step 16,
# seeded from the DMC median of the survivors
register(Experiment(
    name="elastic/planned_churn",
    membership_plan=MembershipPlan(events=(
        MembershipEvent(step=8, kind="leave", group=4),
        MembershipEvent(step=16, kind="join", group=4))),
    **_ELASTIC_COMMON))
# scenario-driven plan: the membership_churn crash windows, realized by the
# netsim engine and lowered to leave/join events (plan_from_trace)
register(Experiment(name="elastic/netsim_churn", scenario="membership_churn",
                    **_ELASTIC_COMMON))

# lm presets: zoo architectures through the protocol — one per trainable
# model family (dense transformer / MoE / RWKV6), reduced configs on the Zipf
# token task. G=4 co-located groups satisfy Table 1 (n_w >= 3·1+1 workers,
# n_ps >= 3·0+2 servers). The "acc" metric is the NEGATIVE eval loss (higher
# is better). ``moe_tiny`` keeps qwen3-moe's bf16 replicas (param_dtype).
_LM_COMMON = dict(
    runner="protocol", n_workers=4, f_workers=1, n_servers=4, f_servers=0,
    T=5, steps=12, batch=4, data="tokens_tiny", schedule="constant",
    lr0=0.02, metrics_every=4, eval_n=64)
register(Experiment(name="lm/tfm_tiny", model="tfm_tiny", **_LM_COMMON))
register(Experiment(name="lm/moe_tiny", model="moe_tiny", **_LM_COMMON))
register(Experiment(name="lm/rwkv_tiny", model="rwkv_tiny", **_LM_COMMON))


# ---------------------------------------------------------------------------
# registry-derived documentation (``python -m repro_torch.exp``)
# ---------------------------------------------------------------------------


def runners_table() -> str:
    """The "Runners" table of the port's own engines: one card, no mesh,
    eager steps (no ``lax.scan``), the reference's rows; the
    collective-volume column is what the protocol's exchange would carry
    across cards (``repro_torch.core.protocol.collective_volume_bytes``)."""
    rows = [
        ("stepwise", "per-step eager loop (`ByzSGDSimulator.run`), host "
         "metrics", "uniform or trace",
         "one card, replica-stacked `[n_ps, D]`", "—"),
        ("fused", "eager epochs of T steps (`EpochEngine`), device metric "
         "buffers, one host transfer", "uniform or trace",
         "one card, replica-stacked `[n_ps, D]`", "—"),
        ("netsim", "fused epochs over the realized netsim trace "
         "(+ cluster accounting in the result)", "trace",
         "one card, replica-stacked `[n_ps, D]`", "—"),
        ("protocol", "eager epochs (`ProtocolEngine`), the G groups "
         "co-located on one card", "uniform or trace",
         "one card, flat `[G, P]` stack, column-chunked passes",
         "none on one card (2(G−1)·P would cross cards)"),
        ("elastic", "protocol epochs chunked at membership boundaries "
         "(`core/membership.py`): quorums re-formed per epoch, checkpointed "
         "resume, DMC-seeded re-admission", "uniform",
         "one card, flat `[G', P]` re-stacked per membership epoch",
         "none on one card (2(G′−1)·P per epoch would cross cards)"),
    ]
    out = ["| runner | loop | delivery | state layout | "
           "per-step collective volume |",
           "|---|---|---|---|---|"]
    for name, loop, deliv, layout, vol in rows:
        out.append(f"| `{name}` | {loop} | {deliv} | {layout} | {vol} |")
    return "\n".join(out)


def models_table() -> str:
    """The "Models" table, one row per ``spec.MODELS`` entry, as the JAX
    package prints it. Zoo archs train only on the protocol runner; their
    "acc" metric is the NEGATIVE eval loss, so higher is better
    everywhere."""
    from ..models.registry import get_config
    from .spec import MODELS, is_arch_model
    out = ["| model | definition | family | runners | `acc` metric |",
           "|---|---|---|---|---|"]
    for name in sorted(MODELS):
        m = MODELS[name]
        if is_arch_model(name):
            defn = f"zoo `{m['arch']}`"
            if m.get("reduced"):
                defn += " (reduced)"
            fam, runners = get_config(m["arch"]).family, "`protocol`"
            metric = "negative eval loss (higher is better)"
        else:
            defn = f"MLP (hidden {m['hidden']}, depth {m['depth']})"
            fam, runners = "mlp", "all"
            metric = "eval accuracy"
        out.append(f"| `{name}` | {defn} | {fam} | {runners} | {metric} |")
    return "\n".join(out)


def markdown_table() -> str:
    """The preset table, one row per registered preset."""
    head = ("| preset | runner | variant | cluster (n_w/f_w, n_ps/f_ps, T) | "
            "gar | attack | steps |")
    out = [head, "|---|---|---|---|---|---|---|"]
    for e in specs():
        atk = "—"
        if e.byz.worker_attack:
            atk = f"{e.byz.worker_attack} ×{e.byz.n_byz_workers} (workers)"
        elif e.byz.server_attack:
            atk = f"{e.byz.server_attack} ×{e.byz.n_byz_servers} (servers)"
        out.append(
            f"| `{e.name}` | {e.runner} | {e.variant} | "
            f"{e.n_workers}/{e.f_workers}, {e.n_servers}/{e.f_servers}, "
            f"T={e.T} | `{e.gar}` | {atk} | {e.steps} |")
    return "\n".join(out)

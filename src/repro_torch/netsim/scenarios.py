"""Declarative scenario library for the netsim engine.

A :class:`Scenario` bundles cluster shape (same resilience preconditions as
``ByzSGDConfig``), the latency/compute models, a fault plan, and payload
sizes. The registry maps names to factories; every factory accepts keyword
overrides (``steps=…``, ``seed=…``, ``model_d=…``) forwarded to the dataclass
so tests and benchmarks can shrink or scale runs::

    sc = scenarios.build("crash_storm", steps=20, seed=3)
    trace = ClusterSim(sc).run()

The *experiment-level* entry point is ``repro_torch.exp``: its
``netsim/<name>`` presets name these scenarios and train over the realized
trace (``exp.run("netsim/crash_storm")``); ``Experiment.to_scenario()``
lowers to this registry. The old module-level ``get()`` survives as a
deprecation shim over :func:`build`.
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from dataclasses import dataclass, field

from .. import agg
from ..core.quorum import validate_counts

from .faults import (CrashPlan, CrashWindow, FaultPlan, LossyLink,
                     PartitionPlan, PartitionWindow, SlowChurn)
from .latency import (ComputeTime, LatencyModel, LognormalLatency,
                      ParetoLatency, TopologyLatency)


@dataclass(frozen=True)
class Scenario:
    name: str = "baseline_uniform"
    # cluster shape (paper Table 1 preconditions enforced in __post_init__)
    n_workers: int = 9
    f_workers: int = 2
    n_servers: int = 5
    f_servers: int = 1
    q_workers: int | None = None
    q_servers: int | None = None
    T: int = 5
    steps: int = 30
    # message schedule: "async" waits on q-of-n quorums; "sync" (§5) pairs
    # each worker with ONE round-robin server per step — one gradient up, one
    # model reply down (server-side round-robin replies; neither direction is
    # a broadcast) — fewer bytes on the wire, the paper's throughput argument
    variant: str = "async"
    # payload: model dimension in scalars (d) and bytes per scalar
    model_d: int = 79_510          # paper's MNIST CNN
    dtype_bytes: int = 4
    # timing
    latency: LatencyModel = field(default_factory=LognormalLatency)
    compute: ComputeTime = field(default_factory=ComputeTime)
    update_ms: float = 0.5
    bandwidth_gbps: float | None = None
    # faults + reproducibility
    faults: FaultPlan = field(default_factory=FaultPlan)
    seed: int = 0
    max_events: int = 5_000_000
    # aggregation rule the servers apply to worker gradients when the trace
    # drives the protocol simulator (any registry name with pytree support;
    # per-role rules — e.g. MDA-at-servers, arXiv:1911.07537 — ride on the
    # simulator's pull_gar/gather_gar knobs)
    gar: str = "mda"
    # Byzantine roles (consumed by the protocol simulator, not the network:
    # netsim only makes these nodes slow/faulty; attacks are injected by
    # core.attacks when the trace drives ByzSGDSimulator)
    worker_attack: str | None = None
    server_attack: str | None = None
    n_byz_workers: int = 0
    n_byz_servers: int = 0

    def __post_init__(self):
        if self.variant not in ("async", "sync"):
            raise ValueError(f"unknown variant {self.variant!r}")
        qw = self.q_workers or (self.n_workers - self.f_workers)
        qs = self.q_servers or max(self.n_servers - self.f_servers,
                                   2 * self.f_servers + 2)
        object.__setattr__(self, "q_workers", qw)
        object.__setattr__(self, "q_servers", qs)
        validate_counts(self.n_workers, self.f_workers, self.n_servers,
                        self.f_servers, qw, qs,
                        synchronous=(self.variant == "sync"))
        agg.get(self.gar).validate(qw, self.f_workers)

    # effective per-step quorum sizes the cluster waits on (the DMC gather
    # keeps q_servers in both variants)
    @property
    def pull_need(self) -> int:
        return 1 if self.variant == "sync" else self.q_servers

    @property
    def push_need(self) -> int:
        """Push-trace row width: in the sync schedule a server receives only
        the gradients of the workers whose round-robin exchange lands on it
        this step (<= ceil(n_w / n_ps)), not all n_w."""
        if self.variant == "sync":
            return -(-self.n_workers // self.n_servers)  # ceil
        return self.q_workers

    def push_scheduled(self, s: int, k: int) -> int:
        """How many gradients server ``s`` waits for at step ``k``: the sync
        schedule assigns worker w to server (w + k) % n_ps, so s's senders are
        the workers w ≡ (s - k) (mod n_ps); async waits on the q_w quorum."""
        if self.variant != "sync":
            return self.q_workers
        r = (s - k) % self.n_servers
        if r >= self.n_workers:
            return 0
        return (self.n_workers - 1 - r) // self.n_servers + 1

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------
# factories — each returns a Scenario; kwargs override any dataclass field.

def baseline_uniform(**kw) -> Scenario:
    """Well-behaved cluster: tight lognormal links, no faults. The analytic
    communication model of exp_messages should hold exactly."""
    kw.setdefault("latency", LognormalLatency(1.0, 0.05))
    return Scenario(name="baseline_uniform", **kw)


def heavy_tail_stragglers(**kw) -> Scenario:
    """Pareto link tail + a rotating set of persistently slow workers: the
    regime where realized quorums are *biased* toward fast nodes, unlike
    Assumption 7's uniform sampling."""
    n_w = kw.pop("n_workers", 9)
    kw.setdefault("latency", ParetoLatency(0.5, alpha=1.6))
    kw.setdefault("faults", FaultPlan(
        churn=SlowChurn(n_nodes=5 + n_w, n_slow=2, factor=12.0,
                        period_ms=40.0)))
    return Scenario(name="heavy_tail_stragglers", n_workers=n_w, **kw)


def partitioned_dmc(**kw) -> Scenario:
    """Two-zone topology; mid-run a partition isolates a minority of servers,
    starving their DMC gather quorums (visible as shortfalls + diameter
    blow-up on the isolated side)."""
    n_ps = kw.pop("n_servers", 5)
    n_w = kw.pop("n_workers", 9)
    zone_of = tuple(i % 2 for i in range(n_ps + n_w))
    kw.setdefault("latency", TopologyLatency(
        zone_of=zone_of, zone_ms=((0.5, 2.5), (2.5, 0.5)),
        jitter=LognormalLatency(1.0, 0.1)))
    minority = tuple(s for s in range(n_ps) if s % 2 == 1)
    majority = tuple(i for i in range(n_ps + n_w) if i not in minority)
    kw.setdefault("faults", FaultPlan(partitions=PartitionPlan((
        PartitionWindow(t0=80.0, t1=220.0, groups=(majority, minority)),))))
    return Scenario(name="partitioned_dmc", n_servers=n_ps, n_workers=n_w,
                    **kw)


def crash_storm(**kw) -> Scenario:
    """Staggered fail-stop crashes with recovery, never exceeding the declared
    f bounds simultaneously: liveness holds but quorums shift and late/dropped
    traffic spikes."""
    n_ps = kw.pop("n_servers", 5)
    n_w = kw.pop("n_workers", 9)
    windows = [CrashWindow(node=0, t_down=40.0, t_up=120.0),          # server
               CrashWindow(node=n_ps + 1, t_down=60.0, t_up=160.0),   # worker
               CrashWindow(node=n_ps + 4, t_down=150.0, t_up=260.0),
               CrashWindow(node=2, t_down=200.0, t_up=280.0)]         # server
    kw.setdefault("faults", FaultPlan(
        crashes=CrashPlan(tuple(windows)),
        lossy=LossyLink(p_drop=0.01, p_dup=0.005)))
    kw.setdefault("latency", LognormalLatency(1.0, 0.3))
    return Scenario(name="crash_storm", n_servers=n_ps, n_workers=n_w, **kw)


def membership_churn(**kw) -> Scenario:
    """One co-located group (server g + worker n_ps+g) fail-stops mid-run and
    recovers — the elastic-training scenario. The elastic runner lowers the
    *realized* crash windows into a MembershipPlan
    (``core.membership.plan_from_trace``): the group leaves before the
    first step finishing after ``t_down`` and stays out for the outage
    duration converted at the honest step rate, so G shrinks 5 -> 4 -> 5.
    Defaults are calibrated to the healthy cadence (~8.5 virtual ms/step
    under the default latency): down around step 8, back around step 16 of a
    24-step run. Shape defaults keep the surviving quorums exactly
    satisfiable while the group is down (4-of-5 up, q = 4)."""
    n_ps = kw.pop("n_servers", 5)
    n_w = kw.pop("n_workers", 5)
    group = kw.pop("churn_group", n_ps - 1)
    t_down = kw.pop("t_down", 66.0)
    t_up = kw.pop("t_up", 134.0)
    kw.setdefault("f_workers", 1)
    kw.setdefault("T", 5)
    windows = (CrashWindow(node=group, t_down=t_down, t_up=t_up),
               CrashWindow(node=n_ps + group, t_down=t_down, t_up=t_up))
    kw.setdefault("faults", FaultPlan(crashes=CrashPlan(windows)))
    kw.setdefault("latency", LognormalLatency(1.0, 0.1))
    return Scenario(name="membership_churn", n_servers=n_ps, n_workers=n_w,
                    **kw)


def byzantine_plus_slow(**kw) -> Scenario:
    """The compound adversary: f_w Byzantine workers that are ALSO slow (their
    messages arrive last, maximizing their staleness leverage) — netsim makes
    them slow, the simulator's attack injection makes them malicious."""
    n_ps = kw.pop("n_servers", 5)
    n_w = kw.pop("n_workers", 9)
    f_w = kw.pop("f_workers", 2)
    byz_nodes = tuple(n_ps + n_w - 1 - i for i in range(f_w))  # last workers
    kw.setdefault("faults", FaultPlan(
        churn=SlowChurn(n_nodes=n_ps + n_w, n_slow=f_w, factor=8.0,
                        only=byz_nodes)))
    kw.setdefault("latency", LognormalLatency(1.0, 0.25))
    kw.setdefault("worker_attack", "alie")
    kw.setdefault("n_byz_workers", f_w)
    return Scenario(name="byzantine_plus_slow", n_servers=n_ps, n_workers=n_w,
                    f_workers=f_w, **kw)


def request_flood(n_clients: int = 1000, rate: float = 2.0, **kw):
    """Serving-side flood against a replicated quorum-read service (see
    :mod:`repro_torch.netsim.flood`). Returns a
    :class:`~repro_torch.netsim.flood.RequestFloodScenario`, NOT a training
    :class:`Scenario` — serving has no Table-1 worker/server
    preconditions, so it lives outside ``SCENARIOS`` (run with
    ``flood.run_flood``, not ``ClusterSim``)."""
    from .flood import RequestFloodScenario
    return RequestFloodScenario(n_clients=n_clients, rate=rate, **kw)


SCENARIOS = {
    "baseline_uniform": baseline_uniform,
    "heavy_tail_stragglers": heavy_tail_stragglers,
    "partitioned_dmc": partitioned_dmc,
    "crash_storm": crash_storm,
    "byzantine_plus_slow": byzantine_plus_slow,
    "membership_churn": membership_churn,
}


def build(name: str, **kw) -> Scenario:
    """Canonical scenario constructor: factory by name, kwargs override any
    dataclass field."""
    try:
        factory = SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"have {sorted(SCENARIOS)}") from None
    return factory(**kw)


def get(name: str, **kw) -> Scenario:
    """Deprecated alias of :func:`build`.

    Scenario presets are subsumed by the experiment registry: prefer
    ``repro_torch.exp.get("netsim/<name>")`` (a full trainable spec) or
    :func:`build` for the bare Scenario.
    """
    warnings.warn(
        "netsim.scenarios.get() is deprecated; use "
        "scenarios.build(name, ...) or the exp presets "
        "(exp.get('netsim/<name>'))", DeprecationWarning, stacklevel=2)
    return build(name, **kw)


# --------------------------------------------------------------------------
# measured compute times: feed a measured steps/sec into the wall-clock model
# instead of the guessed ComputeTime default


def measured_compute(model: str = "mlp_h64", variant: str = "async",
                     path: str | None = None, sigma: float = 0.1
                     ) -> ComputeTime:
    """A :class:`ComputeTime` calibrated from a throughput file at ``path``
    (``{"lanes": {"<variant>/<model>": {"fused": {"steps_per_s": x}}}}``).

    ``1000 / steps_per_s`` of the ``{variant}/{model}`` lane becomes the mean
    per-step compute cost, so netsim's sync-vs-async end-to-end wall-clock
    (§5) runs off *measured* numbers rather than the default guess. The
    measured time includes the server update, so scenarios using it should
    keep ``update_ms`` small to avoid double counting.

    Unlike the JAX package's function, ``path`` has no default: the
    repository's committed throughput file holds the JAX engine's steps/s,
    and no number of that engine enters this package's wall-clock model. No
    scenario factory calls this function.
    """
    if path is None:
        raise ValueError("measured_compute needs path= (a throughput file of "
                         "this package's own steps/s; there is no default)")
    with open(path) as fh:
        bench = json.load(fh)
    lane = f"{variant}/{model}"
    try:
        sps = float(bench["lanes"][lane]["fused"]["steps_per_s"])
    except KeyError:
        raise KeyError(f"lane {lane!r} not in {path}; have "
                       f"{sorted(bench.get('lanes', {}))}") from None
    return ComputeTime(mean_ms=1000.0 / sps, sigma=sigma)

"""The port's netsim (``repro_torch.netsim``) against ``repro.netsim`` on the
CPU, and trace-delivered training against the JAX simulator.

Every scenario factory, in both schedules, and the request flood give the
JAX package's trace: index and staleness tables, step completion times, the
ledger, the event count and the shortfalls. Then the behaviours of
``tests/test_netsim.py`` that need no JAX, the port's own analytic byte
model, ``measured_compute`` (``path=`` only), and the realized
``crash_storm`` trace — whose quorums repeat a sender — driving the port's
stepwise and fused runners against the JAX stepwise loop, with every MDA
selection recorded on both sides.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.agg import registry as jregistry
from repro.configs import paper_models as jmodels
from repro.core import simulator as jsim
from repro.core.quorum import TraceDelivery as JTraceDelivery
from repro.netsim import ClusterSim as JClusterSim
from repro.netsim import run_flood as jrun_flood
from repro.netsim import scenarios as jscenarios
from repro.optim import schedules as jsched
from repro_torch import exp
from repro_torch.agg import registry as tregistry
from repro_torch.core.engine import EpochEngine
from repro_torch.core.quorum import TraceDelivery, UniformDelivery
from repro_torch.core.simulator import coordinatewise_diameter_sum
from repro_torch.data.pipeline import MixtureSpec, classification_stream
from repro_torch.models.convert import sim_state_from_jax
from repro_torch.netsim import ClusterSim, run_flood, scenarios
from repro_torch.netsim.accounting import compare_with_model, model_bytes

SMALL = dict(n_workers=7, f_workers=2, n_servers=5, f_servers=1,
             T=5, steps=10, model_d=1000)
TABLES = ("pull_idx", "push_idx", "gather_idx", "pull_stale", "push_stale",
          "gather_stale", "step_done_ms")


def _run(name, **kw):
    sc = scenarios.build(name, **{**SMALL, **kw})
    return sc, ClusterSim(sc).run()


def _assert_same_trace(mine, ref):
    for f in TABLES:
        a, b = getattr(mine, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert mine.ledger.totals() == ref.ledger.totals()
    assert mine.events == ref.events
    assert mine.shortfalls == ref.shortfalls


# ---------------------------------------------------------------------------
# the trace equals the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["async", "sync"])
@pytest.mark.parametrize("name", sorted(scenarios.SCENARIOS))
def test_scenario_trace_equals_jax(name, variant):
    """20 steps of each scenario factory (T = 5, d = 1000): the same
    realized schedule, staleness, completion times, ledger, event count and
    shortfalls, in both message schedules."""
    kw = {**SMALL, "steps": 20, "variant": variant}
    if name == "membership_churn":
        kw.update(n_workers=5, f_workers=1)
    sc, jsc = scenarios.build(name, **kw), jscenarios.build(name, **kw)
    assert dataclasses.asdict(sc) == dataclasses.asdict(jsc)
    _assert_same_trace(ClusterSim(sc).run(), JClusterSim(jsc).run())


@pytest.mark.parametrize("name", sorted(scenarios.SCENARIOS))
def test_preset_scale_trace_equals_jax(name):
    """Each scenario at its ``netsim/*`` preset's shape (30 steps, the
    paper's d): the traces whose starved quorums repeat a sender."""
    e = exp.get(f"netsim/{name}")
    sc = e.to_scenario()
    jsc = jscenarios.build(name, **{k: getattr(sc, k) for k in (
        "n_workers", "f_workers", "n_servers", "f_servers", "T", "steps",
        "seed", "gar", "variant", "worker_attack", "n_byz_workers")})
    _assert_same_trace(ClusterSim(sc).run(), JClusterSim(jsc).run())


@pytest.mark.parametrize("kw", [dict(n_clients=300, rate=2.0, seed=0),
                                dict(n_clients=400, seed=1,
                                     slow_replicas=(0,), slow_factor=50.0),
                                dict(n_clients=300, seed=2,
                                     deadline_ms=0.1)])
def test_flood_equals_jax(kw):
    """The serving-side request flood: the same request count, quorum
    latencies, per-replica service and lateness, deadline misses and
    ledger."""
    mine = run_flood(scenarios.request_flood(**kw))
    ref = jrun_flood(jscenarios.request_flood(**kw))
    assert mine.n_requests == ref.n_requests
    for f in ("quorum_ms", "replica_busy_ms", "replica_served",
              "replica_late", "max_queue_ms"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(ref, f),
                                      err_msg=f)
    assert mine.deadline_missed == ref.deadline_missed
    assert mine.ledger.totals() == ref.ledger.totals()
    assert mine.wall_ms == ref.wall_ms
    assert mine.summary() == ref.summary()


def test_model_bytes_and_compare_with_model_equal_jax():
    """The port's copy of the analytic byte model, and the uniform
    scenario's comparison through it: a relative error of ~0."""
    from benchmarks.exp_messages import model_bytes as jmodel_bytes
    from repro.netsim.accounting import compare_with_model as jcompare
    for args in ((79_510, 9, 5, 2, 1, 5), (1_093_642, 7, 4, 2, 0, 10, 2)):
        assert model_bytes(*args) == jmodel_bytes(*args)
    sc, t = _run("baseline_uniform", steps=20)
    cmp = compare_with_model(t.ledger, sc, sc.steps, t.n_gathers)
    assert set(cmp) == {"worker_rx", "worker_tx", "server_rx", "server_tx",
                        "dmc_server_exchange"}
    for k, (sim, analytic, rel) in cmp.items():
        assert rel < 1e-9, (k, sim, analytic)
    jsc = jscenarios.build("baseline_uniform", **{**SMALL, "steps": 20})
    jt = JClusterSim(jsc).run()
    assert cmp == jcompare(jt.ledger, jsc, jsc.steps, jt.n_gathers)


def test_measured_compute_needs_a_path(tmp_path):
    """No default file: a throughput file of the port's own steps/s only."""
    with pytest.raises(ValueError, match="path="):
        scenarios.measured_compute()
    p = tmp_path / "throughput.json"
    p.write_text(json.dumps({"lanes": {"async/mlp_h64": {
        "fused": {"steps_per_s": 250.0}}}}))
    ct = scenarios.measured_compute(path=str(p), sigma=0.2)
    assert ct.mean_ms == 4.0 and ct.sigma == 0.2
    with pytest.raises(KeyError, match="sync/mlp_h64"):
        scenarios.measured_compute(variant="sync", path=str(p))


# ---------------------------------------------------------------------------
# behaviours of the cluster simulator (tests/test_netsim.py, no JAX)
# ---------------------------------------------------------------------------


def test_same_seed_bit_identical():
    _, a = _run("crash_storm", seed=11)
    _, b = _run("crash_storm", seed=11)
    for f in TABLES:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.ledger == b.ledger
    assert a.events == b.events and a.shortfalls == b.shortfalls


def test_seed_changes_trace():
    _, a = _run("heavy_tail_stragglers", seed=0)
    _, b = _run("heavy_tail_stragglers", seed=1)
    assert not np.array_equal(a.pull_stale, b.pull_stale)


def test_uniform_quorums_exact():
    sc, t = _run("baseline_uniform")
    assert t.pull_idx.shape == (sc.steps, sc.n_workers, sc.q_servers)
    assert t.push_idx.shape == (sc.steps, sc.n_servers, sc.q_workers)
    for arr, n in ((t.pull_idx, sc.n_servers), (t.push_idx, sc.n_workers)):
        assert arr.min() >= 0 and arr.max() < n
        for row in arr.reshape(-1, arr.shape[-1]):
            assert len(set(row.tolist())) == arr.shape[-1]
    assert t.shortfalls == 0


@pytest.mark.parametrize("name", ["baseline_uniform", "heavy_tail_stragglers",
                                  "crash_storm"])
def test_gather_includes_self(name):
    """A server always aggregates its own model first, even when remote
    models arrive before the server enters the gather round."""
    sc, t = _run(name, steps=20)
    assert t.gather_idx.shape[0] == sc.steps // sc.T
    for r in range(t.gather_idx.shape[0]):
        for s in range(sc.n_servers):
            assert t.gather_idx[r, s][0] == s


def test_staleness_nonnegative_and_populated():
    _, t = _run("heavy_tail_stragglers")
    assert (t.pull_stale >= 0).all() and (t.push_stale >= 0).all()
    assert t.pull_stale.max() > 0


def test_faults_visible_in_ledger():
    _, t = _run("crash_storm", steps=20)
    assert sum(d["dropped_msgs"] for d in t.ledger.totals().values()) > 0
    _, t2 = _run("partitioned_dmc", steps=20)
    assert sum(d["dropped_msgs"] for d in t2.ledger.totals().values()) > 0
    assert t2.shortfalls > 0


def test_trace_always_complete_under_faults():
    sc, t = _run("crash_storm", steps=20)
    assert t.pull_idx.min() >= 0 and t.pull_idx.max() < sc.n_servers
    assert t.push_idx.min() >= 0 and t.push_idx.max() < sc.n_workers
    assert t.gather_idx.min() >= 0 and t.gather_idx.max() < sc.n_servers


def test_fault_plans_compose():
    """Crash inside a partition window, and slow churn pinned on a node
    that also crashes: liveness, reachability and latency compose, and the
    trace still fills every quorum slot."""
    from repro_torch.netsim.faults import (INF, CrashPlan, CrashWindow,
                                           FaultPlan, PartitionPlan,
                                           PartitionWindow, SlowChurn)
    plan = CrashPlan((CrashWindow(node=2, t_down=10.0, t_up=20.0),
                      CrashWindow(node=2, t_down=20.0, t_up=30.0),
                      CrashWindow(node=3, t_down=5.0, t_up=INF)))
    assert plan.next_up(2, 12.0) == 30.0 and plan.next_up(3, 6.0) == INF
    faults = FaultPlan(
        crashes=CrashPlan((CrashWindow(node=1, t_down=20.0, t_up=60.0),)),
        partitions=PartitionPlan((PartitionWindow(
            t0=10.0, t1=80.0, groups=((1,), tuple(range(2, 12)))),)))
    assert not faults.is_up(1, 30.0) and faults.blocked(1, 5, 70.0)
    sc, t = _run("baseline_uniform", steps=20, faults=faults)
    assert t.pull_idx.min() >= 0 and t.pull_idx.max() < sc.n_servers
    assert sum(d["dropped_msgs"] for d in t.ledger.totals().values()) > 0
    slow = FaultPlan(
        crashes=CrashPlan((CrashWindow(node=6, t_down=0.0, t_up=40.0),)),
        churn=SlowChurn(n_nodes=12, n_slow=1, factor=8.0, only=(6,)))
    assert slow.latency_scale(6, 0, 10.0) == 8.0
    assert slow.latency_scale(0, 7, 50.0) == 1.0
    sc, t = _run("baseline_uniform", steps=15, faults=slow)
    assert t.push_idx.min() >= 0 and t.push_idx.max() < sc.n_workers


def test_flood_accounting_and_validation():
    from repro_torch.netsim.flood import RequestFloodScenario
    sc = scenarios.request_flood(n_clients=300, rate=2.0, seed=0)
    tr = run_flood(sc)
    led, Rn = tr.ledger, sc.n_replicas
    assert led.c["push"]["tx_msgs"].sum() == tr.n_requests * Rn
    assert (led.c["pull"]["rx_msgs"].sum() + led.c["pull"]["late_msgs"].sum()
            == tr.n_requests * Rn)
    assert led.c["pull"]["late_msgs"].sum() == tr.replica_late.sum()
    with pytest.raises(ValueError):
        RequestFloodScenario(n_replicas=2, f=1)
    with pytest.raises(ValueError):
        RequestFloodScenario(slow_replicas=(9,))
    assert "request_flood" not in scenarios.SCENARIOS


# ---------------------------------------------------------------------------
# the trace as a delivery model
# ---------------------------------------------------------------------------


def test_trace_delivery_wraps_and_reports_staleness():
    """Steps past the trace wrap around; the per-step mean staleness (and
    the gather's on a round's last step) equals the JAX delivery's; the
    uniform model has none; an empty gather table is refused."""
    _, trace = _run("heavy_tail_stragglers")
    d, jd = trace.to_delivery("cpu"), JTraceDelivery(
        trace.pull_idx, trace.push_idx, trace.gather_idx, T=5,
        pull_stale=trace.pull_stale, push_stale=trace.push_stale,
        gather_stale=trace.gather_stale)
    assert d.pull.device.type == "cpu"
    assert torch.equal(d.pull_indices(None, 3),
                       d.pull_indices(None, 3 + trace.scenario.steps))
    for t in range(2 * trace.scenario.steps):
        assert d.staleness(t) == jd.staleness(t)
    assert "staleness_gather_ms" in d.staleness(4)
    assert UniformDelivery(7, 5, 5, 4).staleness(0) is None
    assert TraceDelivery(trace.pull_idx, trace.push_idx, trace.gather_idx,
                         T=5, device="cpu").staleness(0) is None
    with pytest.raises(ValueError):
        TraceDelivery(np.zeros((5, 7, 4), np.int32),
                      np.zeros((5, 5, 5), np.int32),
                      np.zeros((0, 5, 4), np.int32), T=10, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trace.to_delivery()


MIX = MixtureSpec(n_classes=5, dim=16, sep=2.5)


def _port_sim(delivery):
    e = exp.Experiment(n_workers=7, f_workers=2, n_servers=5, f_servers=1,
                       T=5, model="mlp_h32", data="mixture5_small",
                       lr0=0.05, decay=0.01)
    return e.to_config(), e.build_sim(delivery, device="cpu")


def test_heavy_tail_dmc_still_contracts():
    """Under the heavy-tail straggler trace the DMC gather still shrinks
    the correct servers' diameter (Lemma 4.3 holds for any schedule)."""
    _, trace = _run("heavy_tail_stragglers")
    cfg, sim = _port_sim(trace.to_delivery("cpu"))
    state = sim.init_state(0)
    stream, _ = classification_stream(0, MIX, cfg.n_workers, 16, cfg.T,
                                      "cpu")
    for b in stream:
        state = sim.scatter_step(state, b)
    d_pre = float(coordinatewise_diameter_sum(state.params, cfg.h_servers))
    state = sim.gather_step(state)
    d_post = float(coordinatewise_diameter_sum(state.params, cfg.h_servers))
    assert d_post < 0.9 * d_pre


def test_trace_driven_run_deterministic_with_staleness_in_logs():
    _, trace = _run("heavy_tail_stragglers")

    def go():
        cfg, sim = _port_sim(trace.to_delivery("cpu"))
        stream, _ = classification_stream(0, MIX, cfg.n_workers, 16, 8,
                                          "cpu")
        _, logs = sim.run(sim.init_state(0), stream, metrics_fn=lambda s: {
            "delta": float(coordinatewise_diameter_sum(s.params, 4))},
            metrics_every=7)
        return logs

    a, b = go(), go()
    assert a == b
    assert "staleness_pull_ms" in a[-1]


# ---------------------------------------------------------------------------
# trace-delivered training against the JAX simulator
# ---------------------------------------------------------------------------

# f32 sums run in other orders in the two packages; as the simulator tests
RTOL, ATOL = 2e-4, 2e-5
STEPS = 21                  # > 2T at T = 5: four gathers and a tail


def _record(registry, sink, jax_side):
    """Swap the registry's MDA for one whose ``weights_from_d2`` records
    each selection (``w > 0``) into ``sink``; returns the restore."""
    mda = registry._REGISTRY["mda"]

    def record(d2, f, **kw):
        w = mda.weights_from_d2(d2, f, **kw)
        if jax_side:
            jax.debug.callback(lambda v: sink.append(np.asarray(v) > 0), w)
        else:
            sink.extend(np.asarray(w.reshape(-1, w.shape[-1]) > 0))
        return w

    registry._REGISTRY["mda"] = dataclasses.replace(mda,
                                                    weights_from_d2=record)
    return lambda: registry._REGISTRY.__setitem__("mda", mda)


def test_crash_storm_trace_training_matches_jax():
    """The ``netsim/crash_storm`` preset's realized trace (9/2 workers, 5/1
    servers, T = 5) for 21 steps at ``mlp_h32``: push quorums repeat a
    sender from step 4, pull quorums at steps 15 and 18, and the gather of
    round 3. The port's stepwise loop and fused engine against the JAX
    stepwise loop from one state on numpy batches: params within
    (2e-4, 2e-5), and every MDA selection (21 steps x 5 servers) the same,
    ties between a repeated sender's copies included."""
    e = exp.get("netsim/crash_storm")
    cfg = e.to_config()
    trace = ClusterSim(e.to_scenario()).run()

    def repeats(idx, n_recv, q):
        return {k for k in range(STEPS) for r in range(n_recv)
                if len(set(idx[k, r].tolist())) < q}

    assert min(repeats(trace.push_idx, cfg.n_servers, cfg.q_workers)) == 4
    assert {15, 18} <= repeats(trace.pull_idx, cfg.n_workers, cfg.q_servers)
    assert any(len(set(row.tolist())) < cfg.q_servers
               for row in trace.gather_idx[3])
    jcfg = jsim.ByzSGDConfig(n_workers=9, f_workers=2, n_servers=5,
                             f_servers=1, T=5)
    jinit, jloss, _ = jmodels.make_mlp_problem(dim=16, hidden=32,
                                               n_classes=5, l2=e.l2)
    js = jsim.ByzSGDSimulator(jcfg, jinit, jloss,
                              jsched.inverse_linear(e.lr0, e.decay),
                              delivery=JTraceDelivery(
                                  trace.pull_idx, trace.push_idx,
                                  trace.gather_idx, T=5))
    rng = np.random.default_rng(5)
    y = rng.integers(0, 5, (STEPS, 9, e.batch))
    x = (2.5 * np.eye(5, 16)[y] + rng.standard_normal(y.shape + (16,))
         ).astype(np.float32)
    y = y.astype(np.int32)
    j0 = js.init_state(jax.random.PRNGKey(0))
    jsel: list = []
    restore = _record(jregistry, jsel, True)
    try:
        jend, _ = js.run(j0, [(jnp.asarray(x[i]), jnp.asarray(y[i]))
                              for i in range(STEPS)], jit=False)
    finally:
        restore()
    jax.effects_barrier()
    want = None
    for runner in ("stepwise", "fused"):
        sim = e.build_sim(trace.to_delivery("cpu"), device="cpu")
        t0 = sim_state_from_jax(jax.tree.map(np.asarray, j0), cfg, "cpu")
        if want is None:
            want = sim.tree.flatten({k: torch.from_numpy(np.asarray(v))
                                     for k, v in jend.params.items()},
                                    lead=1)
        xs, ys = torch.from_numpy(x), torch.from_numpy(y).long()
        tsel: list = []
        restore = _record(tregistry, tsel, False)
        try:
            if runner == "stepwise":
                tend, _ = sim.run(t0, [(xs[i], ys[i]) for i in range(STEPS)])
            else:
                tend, _ = EpochEngine(sim).run(t0, (xs, ys))
        finally:
            restore()
        assert tend.t == STEPS
        torch.testing.assert_close(tend.params, want, rtol=RTOL, atol=ATOL)
        assert len(tsel) == len(jsel) == STEPS * cfg.n_servers
        for k, (a, b) in enumerate(zip(tsel, jsel)):
            np.testing.assert_array_equal(a, b, err_msg=f"{runner} {k}")

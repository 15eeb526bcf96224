"""The port's elastic membership (``core/membership.py``, ``runner=
"elastic"``) against ``repro.core.membership`` and ``repro.exp``, on the
CPU: a counterpart of every test of ``tests/test_membership.py`` (plan
mechanics, churn-driven quorums, replica re-forming and the netsim lowering
compared with JAX on shared inputs; spec validation; the elastic gates —
empty plan bit-identical to ``runner="protocol"``, churn convergence,
kill-and-resume mid-churn bit-identical, the final checkpoint), and
``elastic/planned_churn`` through both packages' elastic runners on
replayed quorum tables and numpy batches: every MDA selection equal, params
within float32 summation noise. Nothing here runs the JAX package's
multi-process elastic lane."""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.exp as jexp
import repro_torch.exp as exp
from repro.core import membership as jmem
from repro.core import protocol as jproto
from repro.core.attacks import ByzantineSpec as JByzantineSpec
from repro.core.quorum import TraceDelivery as JTraceDelivery
from repro.netsim import ClusterSim as JClusterSim
from repro.netsim import scenarios as jscenarios
from repro_torch.checkpoint import checkpointer as ck
from repro_torch.core import protocol as tproto
from repro_torch.core.attacks import ByzantineSpec
from repro_torch.core.membership import (MembershipEpoch, MembershipEvent,
                                         MembershipFloorError, MembershipPlan,
                                         epoch_config, plan_from_trace,
                                         reform_params)
from repro_torch.core.quorum import TraceDelivery
from repro_torch.exp import runners as truns
from repro_torch.models.convert import protocol_state_from_jax
from repro_torch.netsim import ClusterSim, scenarios

# ---------------------------------------------------------------------------
# plan mechanics
# ---------------------------------------------------------------------------


def test_event_validation():
    with pytest.raises(ValueError, match="kind"):
        MembershipEvent(step=3, kind="vanish", group=0)
    with pytest.raises(ValueError, match="boundaries"):
        MembershipEvent(step=0, kind="leave", group=0)
    with pytest.raises(ValueError, match="group"):
        MembershipEvent(step=3, kind="leave", group=-1)


def test_plan_normalizes_and_roundtrips_as_in_jax():
    events = ({"step": 16, "kind": "join", "group": 4},
              MembershipEvent(step=8, kind="leave", group=4))
    plan = MembershipPlan(events=events)
    assert [e.step for e in plan.events] == [8, 16]
    assert MembershipPlan.from_dict(plan.to_dict()) == plan
    assert MembershipPlan.from_dict({"events": []}) == MembershipPlan()
    ref = jmem.MembershipPlan(events=(
        {"step": 16, "kind": "join", "group": 4},
        jmem.MembershipEvent(step=8, kind="leave", group=4)))
    assert plan.to_dict() == ref.to_dict()


PLANS = [
    (),
    ((8, "leave", 4), (16, "join", 4)),
    ((3, "leave", 1), (3, "leave", 2), (9, "join", 1)),
    ((6, "join", 5),),
]


@pytest.mark.parametrize("events", PLANS)
def test_epochs_segmentation_matches_jax(events):
    mine = MembershipPlan(events=tuple(MembershipEvent(*e) for e in events))
    ref = jmem.MembershipPlan(events=tuple(jmem.MembershipEvent(*e)
                                           for e in events))
    got = mine.epochs(5, 24)
    assert [dataclasses.astuple(s) for s in got] == [
        dataclasses.astuple(s) for s in ref.epochs(5, 24)]
    if events == PLANS[1]:
        assert [(s.start, s.stop, s.active) for s in got] == [
            (0, 8, (0, 1, 2, 3, 4)), (8, 16, (0, 1, 2, 3)),
            (16, 24, (0, 1, 2, 3, 4))]
    if not events:
        assert got == (MembershipEpoch(0, 24, (0, 1, 2, 3, 4)),)
    if events == PLANS[3]:
        assert got[-1].active == (0, 1, 2, 3, 4, 5)


@pytest.mark.parametrize("event,match", [
    ((30, "leave", 0), "outside the run"),
    ((4, "leave", 7), "not active"),
    ((4, "join", 2), "already active")])
def test_epochs_validation(event, match):
    with pytest.raises(ValueError, match=match):
        MembershipPlan(events=(MembershipEvent(*event),)).epochs(5, 24)
    with pytest.raises(ValueError, match=match):
        jmem.MembershipPlan(events=(jmem.MembershipEvent(*event),)).epochs(
            5, 24)


# ---------------------------------------------------------------------------
# churn-driven quorum derivation
# ---------------------------------------------------------------------------


def _pcfgs(byz=None, **kw):
    jp = jproto.ProtocolConfig.derive(
        5, f_workers=1, f_servers=1, T=5,
        byz=JByzantineSpec(**(byz or {})), **kw)
    tp = tproto.ProtocolConfig.derive(
        5, f_workers=1, f_servers=1, T=5, byz=ByzantineSpec(**(byz or {})),
        **kw)
    return jp, tp


FIELDS = ("n_groups", "f_workers", "f_servers", "q_workers", "q_servers",
          "T", "gar", "pull_gar", "gather_gar")


@pytest.mark.parametrize("active,sync", [
    ((0, 1, 2, 3, 4), False), ((0, 1, 2, 3), False), ((0, 2, 3), True),
    ((1, 2, 3), False), ((0, 1, 2, 3, 4, 5), False)])
def test_epoch_config_matches_jax(active, sync):
    jp, tp = _pcfgs()
    mine = epoch_config(tp, active, synchronous=sync)
    ref = jmem.epoch_config(jp, active, synchronous=sync)
    assert {k: getattr(mine, k) for k in FIELDS} == {
        k: getattr(ref, k) for k in FIELDS}
    if len(active) == 5:
        assert mine is tp
    if active == (0, 1, 2, 3):
        assert (mine.n_groups, mine.f_workers, mine.f_servers) == (4, 1, 0)
        assert (mine.q_workers, mine.q_servers) == (3, 4)
    if sync:
        assert (mine.f_workers, mine.q_workers) == (0, 3)


def test_epoch_config_floor_errors():
    _, tp = _pcfgs()
    with pytest.raises(MembershipFloorError, match=">= 2 groups"):
        epoch_config(tp, (0,))
    _, byz = _pcfgs(byz=dict(server_attack="lie", n_byz_servers=1))
    with pytest.raises(MembershipFloorError, match="outvote"):
        epoch_config(byz, (0, 1, 2, 3))


# ---------------------------------------------------------------------------
# replica re-forming
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("old,new", [
    ((0, 1, 2, 3, 4), (0, 1, 2, 3)), ((0, 1, 2, 3), (0, 1, 2, 3, 4)),
    ((0, 2, 4), (0, 1, 2, 3, 4)), ((1, 3, 4, 6), (0, 1, 3, 6))])
def test_reform_params_matches_jax(old, new):
    """Survivors carried, joiners seeded from the survivors' median: the
    flat ``[G, P]`` stack of the port equals JAX's tree re-formed leaf by
    leaf (odd and even survivor counts), in column chunks narrower than a
    row."""
    rng = np.random.default_rng(len(old) * 7 + len(new))
    tree = {"w": rng.standard_normal((len(old), 3, 5)).astype(np.float32),
            "b": rng.standard_normal((len(old), 4)).astype(np.float32)}
    want = jmem.reform_params(jax.tree.map(jnp.asarray, tree), old, new)
    flat = torch.from_numpy(np.concatenate(
        [tree["b"].reshape(len(old), -1), tree["w"].reshape(len(old), -1)],
        axis=1))
    got = reform_params(flat, old, new, chunk_bytes=4 * 3 * 7)
    exp_flat = np.concatenate(
        [np.asarray(want["b"]).reshape(len(new), -1),
         np.asarray(want["w"]).reshape(len(new), -1)], axis=1)
    np.testing.assert_allclose(got.numpy(), exp_flat, rtol=1e-7, atol=0)
    carried = [i for i, g in enumerate(new) if g in old]
    np.testing.assert_array_equal(
        got[carried].numpy(),
        flat[[old.index(new[i]) for i in carried]].numpy())


def test_reform_params_shrinks_exactly_and_keeps_the_dtype():
    flat = torch.arange(20.0).reshape(5, 4).bfloat16()
    shrunk = reform_params(flat, (0, 1, 2, 3, 4), (0, 1, 2, 3))
    assert torch.equal(shrunk, flat[:4])
    grown = reform_params(shrunk, (0, 1, 2, 3), (0, 1, 2, 3, 4))
    assert grown.dtype == torch.bfloat16 and torch.equal(grown[:4], shrunk)
    # rows increase, so the median of the 4 survivors is the mean of rows
    # 1 and 2, in float32, rounded once
    want = (0.5 * (shrunk[1].float() + shrunk[2].float())).bfloat16()
    assert torch.equal(grown[4], want)


def test_reform_params_needs_a_survivor():
    with pytest.raises(MembershipFloorError, match="surviving"):
        reform_params(torch.ones((2, 3)), (0, 1), (2, 3))


# ---------------------------------------------------------------------------
# netsim lowering
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(steps=24), dict(steps=24, t_down=66.0, t_up=float("inf")),
    dict(steps=40)])
def test_plan_from_trace_matches_jax(kw):
    """The port's netsim trace of ``membership_churn`` lowers to JAX's plan
    (a multi-step outage: leave then join of group 4; without recovery a
    leave only)."""
    sc = scenarios.build("membership_churn", **kw)
    plan = plan_from_trace(sc, ClusterSim(sc).run())
    jsc = jscenarios.build("membership_churn", **kw)
    ref = jmem.plan_from_trace(jsc, JClusterSim(jsc).run())
    assert plan.to_dict() == ref.to_dict()
    kinds = [(e.kind, e.group) for e in plan.events]
    if np.isfinite(kw.get("t_up", 0.0)):
        assert kinds == [("leave", 4), ("join", 4)]
        leave, join = plan.events[0].step, plan.events[1].step
        assert 1 <= leave < join < kw["steps"] and join - leave >= 4
    else:
        assert kinds == [("leave", 4)]


# ---------------------------------------------------------------------------
# spec validation
# ---------------------------------------------------------------------------


def test_membership_plan_requires_elastic_runner():
    plan = MembershipPlan(events=(
        MembershipEvent(step=4, kind="leave", group=4),))
    with pytest.raises(ValueError, match="elastic"):
        exp.get("smoke", membership_plan=plan)
    with pytest.raises(ValueError, match="uniform"):
        exp.get("elastic/static", delivery="trace")
    with pytest.raises(MembershipFloorError, match="outvote"):
        exp.get("elastic/planned_churn",
                byz=ByzantineSpec(server_attack="lie", n_byz_servers=1))


def test_membership_plan_json_roundtrip_hashes_as_jax():
    e = exp.get("elastic/planned_churn")
    back = exp.Experiment.from_dict(e.to_dict())
    assert back == e and back.membership_plan == e.membership_plan
    assert e.spec_hash == jexp.get("elastic/planned_churn").spec_hash


# ---------------------------------------------------------------------------
# elastic runner gates (the port on its own)
# ---------------------------------------------------------------------------


def test_empty_plan_elastic_bit_identical_to_protocol():
    rp = exp.run("elastic/static", runner="protocol", device="cpu")
    re_ = exp.run("elastic/static", device="cpu")
    assert torch.equal(rp.state.params, re_.state.params)
    for k in rp.buffers:
        np.testing.assert_array_equal(rp.buffers[k], re_.buffers[k])
    assert rp.logs == re_.logs and rp.final == re_.final
    assert re_.provenance["membership"]["plan_source"] == "static"


def test_churn_converges_within_tolerance_of_static():
    static = exp.run("elastic/static", device="cpu")
    churned = exp.run("elastic/planned_churn", device="cpu")
    assert churned.final["acc"] >= static.final["acc"] - 0.1
    mem = churned.provenance["membership"]
    assert [len(ep["active"]) for ep in mem["epochs"]] == [5, 4, 5]
    assert mem["plan_source"] == "spec"
    assert churned.state.params.shape[0] == 5


def test_netsim_churn_lowers_and_converges():
    res = exp.run("elastic/netsim_churn", device="cpu")
    mem = res.provenance["membership"]
    assert mem["plan_source"] == "scenario:membership_churn"
    assert [len(ep["active"]) for ep in mem["epochs"]] == [5, 4, 5]
    assert res.final["acc"] >= 0.8
    assert res.netsim is not None and "virtual_ms" in res.netsim


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_kill_and_resume_mid_churn_bit_identical(tmp_path, optimizer):
    """Killed after step 12 (mid-shrunk epoch, so the resume restores at
    G' = 4 with its generator, and AdamW's moments re-stacked at the
    boundaries), resumed: the uninterrupted run's params, final metrics and
    log tail, bit for bit."""
    kw = dict(device="cpu", optimizer=optimizer)
    if optimizer == "adamw":
        kw.update(schedule="constant", lr0=0.01)
    oracle = exp.run("elastic/planned_churn", **kw)
    d = os.path.join(str(tmp_path), "ck")
    full = exp.run("elastic/planned_churn", ckpt_dir=d, ckpt_every=4, **kw)
    assert torch.equal(oracle.state.params, full.state.params)
    assert ck.read_manifest(d, 8)["meta"]["active"] == [0, 1, 2, 3]
    assert ck.read_manifest(d, 16)["meta"]["active"] == [0, 1, 2, 3, 4]
    for name in sorted(os.listdir(d)):
        if int(name.split("_")[-1]) > 12:
            shutil.rmtree(os.path.join(d, name))
    resumed = exp.run("elastic/planned_churn", ckpt_dir=d, ckpt_every=4,
                      **kw)
    assert resumed.provenance["membership"]["resumed_at"] == 12
    assert torch.equal(oracle.state.params, resumed.state.params)
    if optimizer == "adamw":
        assert torch.equal(oracle.state.opt.m, resumed.state.opt.m)
    assert resumed.final == oracle.final
    by_step = {m["step"]: m for m in oracle.logs}
    assert resumed.logs and all(m == by_step[m["step"]]
                                for m in resumed.logs)


def test_resume_refuses_a_checkpoint_of_another_plan(tmp_path):
    d = str(tmp_path / "ck")
    exp.run("elastic/planned_churn", ckpt_dir=d, ckpt_every=4, device="cpu")
    for name in sorted(os.listdir(d)):
        if int(name.split("_")[-1]) > 12:
            shutil.rmtree(os.path.join(d, name))
    with pytest.raises(ValueError, match="does not belong"):
        exp.run("elastic/static", ckpt_dir=d, device="cpu")


def test_elastic_final_checkpoint_without_ckpt_every(tmp_path):
    d = os.path.join(str(tmp_path), "ck")
    res = exp.run("elastic/planned_churn", ckpt_dir=d, device="cpu")
    assert ck.latest_step(d) == res.experiment.steps
    meta = ck.read_manifest(d, res.experiment.steps).get("meta")
    assert meta["elastic"] and list(meta["active"]) == [0, 1, 2, 3, 4]
    assert sorted(os.listdir(d)) == [f"step_{s:08d}" for s in (8, 16, 24)]


# ---------------------------------------------------------------------------
# elastic/planned_churn through both runners on replayed randomness
# ---------------------------------------------------------------------------


class _Replay:
    """Quorum tables per fleet size (global-step indexed, the whole run),
    numpy batches at the launch width and an eval set, drawn once; both
    packages' runners read them through the patches of :func:`_patch`."""

    def __init__(self, e, seed=0):
        self.e = e
        self.rng = np.random.default_rng(seed)
        mix = e.mixture
        G0, b = e.n_workers, e.batch
        y = self.rng.integers(0, mix.n_classes, (e.steps, G0, b))
        x = self.rng.standard_normal((e.steps, G0, b, mix.dim))
        x += 2.0 * np.eye(mix.n_classes, mix.dim)[y]
        self.x, self.y = x.astype(np.float32), y.astype(np.int32)
        ey = self.rng.integers(0, mix.n_classes, 64)
        self.ex = (self.rng.standard_normal((64, mix.dim))
                   + 2.0 * np.eye(mix.n_classes, mix.dim)[ey]).astype(
                       np.float32)
        self.ey = ey.astype(np.int32)
        self.tables = {}

    def table(self, pcfg):
        key = (pcfg.n_groups, pcfg.q_workers, pcfg.q_servers)
        if key not in self.tables:
            G, q_w, q_ps = key
            steps, T = self.e.steps, self.e.T

            def pick(q, self_first=False):
                out = np.empty((G, q), np.int32)
                for r in range(G):
                    if self_first:
                        others = self.rng.permutation(
                            [s for s in range(G) if s != r])
                        out[r] = np.concatenate([[r], others[:q - 1]])
                    else:
                        out[r] = self.rng.permutation(G)[:q]
                return out

            self.tables[key] = (
                np.stack([pick(q_ps) for _ in range(steps)]),
                np.stack([pick(q_w) for _ in range(steps)]),
                np.stack([pick(q_ps, True) for _ in range(steps // T)]))
        return self.tables[key]

    def stream(self, to):
        replay = self

        class Stream:
            def __init__(self, *a, **k):
                self.i = 0

            def eval_set(self, n):
                return to(replay.ex), to(replay.ey)

            def next(self, length, n_workers=None):
                nw = n_workers or replay.x.shape[1]
                sl = slice(self.i, self.i + length)
                self.i += length
                return to(replay.x[sl, :nw]), to(replay.y[sl, :nw])

            def skip(self, length):
                self.i += length

        return Stream


def _patch(monkeypatch, replay, j0):
    """Both elastic runners on the replay: each epoch's engine replays the
    tables of its fleet size and starts from ``j0``; every MDA selection
    (the quorum weights) is recorded."""
    import repro.exp.runners as jruns
    sel = {"jax": [], "port": []}
    keep = []

    class JEngine(jproto.ProtocolEngine):
        def __init__(self, bundle, pcfg, lr, **kw):
            kw["delivery"] = JTraceDelivery(*replay.table(pcfg), T=pcfg.T)
            keep.append(kw["delivery"])
            super().__init__(bundle, pcfg, lr, **kw)

        def init_state(self, key):
            return jax.tree.map(jnp.asarray, j0)

    class TEngine(tproto.ProtocolEngine):
        def __init__(self, bundle, pcfg, lr, **kw):
            kw["delivery"] = TraceDelivery(*replay.table(pcfg), T=pcfg.T,
                                           device="cpu")
            super().__init__(bundle, pcfg, lr, **kw)

        def init_state(self, seed):
            return protocol_state_from_jax(j0, "cpu")

    jq, tq = jproto.quorum_weights, tproto.quorum_weights

    def jrec(d2, idx, f, cfg):
        w = jq(d2, idx, f, cfg)
        jax.debug.callback(lambda x: sel["jax"].append(np.asarray(x)), w,
                           ordered=True)
        return w

    def trec(d2, idx, f, cfg):
        w = tq(d2, idx, f, cfg)
        sel["port"].append(w.numpy().copy())
        return w

    monkeypatch.setattr(jproto, "ProtocolEngine", JEngine)
    monkeypatch.setattr(jproto, "quorum_weights", jrec)
    monkeypatch.setattr(jruns, "DeviceBatchStream",
                        replay.stream(jnp.asarray))
    monkeypatch.setattr(tproto, "ProtocolEngine", TEngine)
    monkeypatch.setattr(tproto, "quorum_weights", trec)
    monkeypatch.setattr(truns, "DeviceBatchStream", replay.stream(
        lambda a: torch.from_numpy(np.ascontiguousarray(a)).long()
        if a.dtype == np.int32 else torch.from_numpy(
            np.ascontiguousarray(a))))
    return sel


def test_planned_churn_matches_jax_on_replayed_randomness(monkeypatch):
    """``elastic/planned_churn`` (G 5 -> 4 at step 8, back to 5 at 16,
    24 steps) through the JAX and the port's elastic runners from one
    initial state, on the same quorum tables per fleet size and the same
    numpy batches: the same epochs, every step's MDA selection the same
    (and its weights equal), params within float32 summation noise."""
    e = jexp.get("elastic/planned_churn")
    replay = _Replay(e)
    j0 = jax.tree.map(np.asarray, jproto.make_init_fn(
        jproto.ProblemBundle(*e.build_problem()[:2]),
        e.to_protocol_config())(jax.random.PRNGKey(e.seed)))
    sel = _patch(monkeypatch, replay, j0)
    jres = jexp.run(e)
    tres = exp.run("elastic/planned_churn", device="cpu")
    assert (tres.provenance["membership"]["epochs"]
            == jres.provenance["membership"]["epochs"])
    assert len(sel["port"]) == len(sel["jax"]) == e.steps
    for t, (a, b) in enumerate(zip(sel["jax"], sel["port"])):
        assert a.shape == b.shape, t
        np.testing.assert_array_equal(a > 0, b > 0, err_msg=f"step {t}")
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6,
                                   err_msg=f"step {t}")
    want = protocol_state_from_jax(jax.tree.map(np.asarray, jres.state),
                                   "cpu")
    assert tres.state.t == want.t == e.steps
    torch.testing.assert_close(tres.state.params, want.params, rtol=2e-4,
                               atol=2e-5)
    assert abs(tres.final["acc"] - jres.final["acc"]) <= 1 / 64

"""repro_torch.serve: the tests/test_serve.py gates on the port (quorum reads
under every model attack x both read rules, detector, pool, batcher,
service), plus end-to-end parity: the JAX and the port's QuorumService on
the same converted params generate identical tokens, and on a JAX
checkpoint of a reduced transformer restored by each package's
``ReplicaPool.from_checkpoint``."""
import types

import jax
import numpy as np
import pytest
import torch

import repro_torch.agg as agg
from _torch_parity import CPU, jax_tree, numpy_params
from repro.models.registry import get_bundle as jax_bundle
from repro.serve import QuorumService as JaxQuorumService
from repro.serve import ReplicaPool as JaxReplicaPool
from repro_torch.core.attacks import MODEL_ATTACKS, ByzantineSpec, inject_models
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_bundle
from repro_torch.serve import (DetectorConfig, DivergenceDetector,
                               QuorumService, ReplicaPool, disagreement,
                               quorum_tokens)
from repro_torch.serve import quorum
from repro_torch.serve.batcher import ContinuousBatcher

R, F = 4, 1


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _normal(seed, *shape):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


# ---------------------------------------------------------------------------
# read rules
# ---------------------------------------------------------------------------


def test_vote_rule_plurality():
    x = torch.tensor([[3, 7], [3, 9], [5, 9], [3, 9]], dtype=torch.int32)
    assert agg.get("vote")(x, 1).tolist() == [3, 9]
    m = np.asarray([True, False, True, True])
    sub = agg.get("vote")(x, 1, mask=m)
    assert sub.tolist() == agg.get("vote")(x[torch.from_numpy(m)], 1).tolist()


@pytest.mark.parametrize("attack", sorted(MODEL_ATTACKS))
@pytest.mark.parametrize("rule", ("median", "vote"))
def test_quorum_reads_survive_every_model_attack(attack, rule):
    honest = _normal(0, 2, 16)                       # [B, V] logits
    stack = honest.expand((R,) + honest.shape)
    spec = ByzantineSpec(server_attack=attack, n_byz_servers=F)
    corrupted = inject_models({"logits": stack}, spec, _gen(1))["logits"]
    assert not torch.equal(corrupted[-1], honest)
    toks = quorum_tokens(corrupted, F, rule=rule)
    np.testing.assert_array_equal(toks.numpy(), honest.argmax(-1).numpy())


def test_disagreement_metric():
    honest = _normal(2, 3, 8)
    stack = honest.expand((R,) + honest.shape).clone()
    toks = quorum_tokens(stack, F)
    assert disagreement(stack, toks.numpy()) == 0.0
    stack[-1] = -stack[-1]
    toks = quorum_tokens(stack, F)
    assert disagreement(stack, toks.numpy()) > 0.0


# ---------------------------------------------------------------------------
# divergence detector
# ---------------------------------------------------------------------------


def test_detector_ejects_attacker_within_patience_reads():
    det = DivergenceDetector(R, F, DetectorConfig(patience=3))
    active = np.ones(R, bool)
    dist = np.array([0.0, 0.0, 0.0, 1.0])
    assert det.observe(dist, active) == []
    assert det.observe(dist, active) == []
    assert det.observe(dist, active) == [3]
    assert det.flagged[3] and not det.flagged[:3].any()


def test_detector_never_ejects_honest_on_clean_runs():
    det = DivergenceDetector(R, F)
    rng = np.random.default_rng(0)
    active = np.ones(R, bool)
    for _ in range(50):
        assert det.observe(1.0 + 0.05 * rng.standard_normal(R), active) == []
    assert not det.flagged.any()


def test_detector_respects_quorum_floor():
    det = DivergenceDetector(3, 1, DetectorConfig(patience=1))
    ejected = det.observe(np.array([0.0, 0.0, 5.0]), np.ones(3, bool))
    assert ejected == [] and det.flagged[2]


def test_detector_probation_reejects_on_single_outlier():
    det = DivergenceDetector(R, F, DetectorConfig(patience=3, probation=4))
    det.flagged[3] = True
    det.readmit(3)
    assert not det.flagged[3] and det.probation[3] == 4
    assert det.observe(np.array([0.0, 0.0, 0.0, 1.0]),
                       np.ones(R, bool)) == [3]


def test_detector_probation_expires_back_to_patience():
    det = DivergenceDetector(R, F, DetectorConfig(patience=3, probation=2))
    active = np.ones(R, bool)
    det.readmit(3)
    det.observe(np.zeros(R), active)
    det.observe(np.zeros(R), active)
    assert det.probation[3] == 0
    dist = np.array([0.0, 0.0, 0.0, 1.0])
    assert det.observe(dist, active) == []
    assert det.observe(dist, active) == []
    assert det.observe(dist, active) == [3]


def test_detector_distances():
    logits = _normal(3, R, 2, 5)
    answer = logits[0]
    want = torch.sqrt(((logits - answer) ** 2).mean(dim=(1, 2))).numpy()
    np.testing.assert_allclose(DivergenceDetector.distances(logits, answer),
                               want, rtol=1e-6)


# ---------------------------------------------------------------------------
# replica pool
# ---------------------------------------------------------------------------


def _tiny_params(seed):
    return {"w": _normal(seed, 4, 3), "b": _normal(seed + 1, 3)}


def test_replica_pool_constructors_and_validation():
    p = _tiny_params(0)
    pool = ReplicaPool.from_params(p, R, f=F)
    assert pool.n_replicas == R and pool.n_active == R
    assert pool.quorum_floor == 2 * F + 1
    stacked = {k: torch.stack([v] * R) for k, v in p.items()}
    assert ReplicaPool.from_stacked(stacked, f=F).n_replicas == R
    for k in p:
        assert torch.equal(pool.single(2)[k], p[k])
    with pytest.raises(ValueError, match="2f"):
        ReplicaPool.from_params(p, 2, f=1)
    with pytest.raises(ValueError, match="active"):
        ReplicaPool(params=stacked, f=F, active=np.ones(R + 1, bool))


def test_consolidated_outvotes_corruption():
    p = _tiny_params(1)
    pool = ReplicaPool.from_params(p, 5, f=2).corrupt(
        ByzantineSpec(server_attack="reversed", n_byz_servers=2))
    for k in p:
        assert torch.equal(pool.consolidated()[k], p[k])
    with pytest.raises(ValueError, match="tolerance"):
        ReplicaPool.from_params(p, 5, f=1).corrupt(
            ByzantineSpec(server_attack="random", n_byz_servers=2), _gen(3))


def test_consolidated_reads_through_the_median_dispatch(monkeypatch):
    """The consolidated read goes through ``agg.dispatch.cwise_median``
    (the median kernel on a CUDA tensor), once per leaf, over the active
    replicas only."""
    p = _tiny_params(2)
    pool = ReplicaPool.from_params(p, 5, f=1).corrupt(
        ByzantineSpec(server_attack="reversed", n_byz_servers=1))
    seen = []
    inner = agg.dispatch.cwise_median
    monkeypatch.setattr(agg.dispatch, "cwise_median",
                        lambda x, **k: seen.append(x.shape) or inner(x, **k))
    assert pool.deactivate(4)
    cons = pool.consolidated()
    assert len(seen) == len(p) and all(n == 4 for n, _ in seen)
    for k in p:
        assert torch.equal(cons[k], p[k])


def test_corrupt_leaves_broadcast_source_untouched():
    p = _tiny_params(4)
    keep = {k: v.clone() for k, v in p.items()}
    pool = ReplicaPool.from_params(p, R, f=F).corrupt(
        ByzantineSpec(server_attack="lie", n_byz_servers=1))
    for k in p:
        assert torch.equal(p[k], keep[k])
        torch.testing.assert_close(pool.params[k][-1], 1.035 * keep[k])


def test_deactivate_respects_floor():
    pool = ReplicaPool.from_params(_tiny_params(4), R, f=F)
    assert pool.deactivate(3)
    assert pool.n_active == 3
    assert not pool.deactivate(2)
    assert not pool.deactivate(3)


def test_reactivate_heals_from_quorum_median():
    p = _tiny_params(6)
    pool = ReplicaPool.from_params(p, R, f=F).corrupt(
        ByzantineSpec(server_attack="reversed", n_byz_servers=1))
    assert pool.deactivate(R - 1)
    assert not pool.reactivate(0)
    assert pool.reactivate(R - 1)
    assert pool.n_active == R
    for k in p:
        assert torch.equal(pool.single(R - 1)[k], p[k])


# ---------------------------------------------------------------------------
# batcher (host-side)
# ---------------------------------------------------------------------------


def test_batcher_admission_queue_and_refill():
    b = ContinuousBatcher(n_slots=2, max_queue=2)
    r1, r2 = b.submit([1]), b.submit([2])
    assert [r.rid for r in b.fill()] == [0, 1]
    r3, r4 = b.submit([3]), b.submit([4])
    r5 = b.submit([5])
    assert r5.status == "rejected" and b.rejected == 1
    assert b.fill() == []
    b.finish(r1)
    assert b.fill() == [r3] and b.refills == 1
    assert b.pending == 1 and not b.idle
    b.finish(r2), b.finish(r3)
    b.fill()
    b.finish(r4)
    assert b.idle


def test_batcher_deadline_expiry():
    b = ContinuousBatcher(n_slots=1)
    req = b.submit([1, 2], deadline_ms=0.0)
    b.fill()
    assert b.expire() == [req] and req.status == "deadline"
    assert not req.deadline_met and req.latency_s is not None
    assert b.slots[0] is None


# ---------------------------------------------------------------------------
# quorum service (transformer decode path)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bundle():
    return get_bundle("phi4-mini-3.8b", reduced=True)


@pytest.fixture(scope="module")
def tparams(bundle):
    return params_from_jax(numpy_params(bundle.cfg, 0), bundle.cfg,
                           device=CPU)


def _serve(pool, bundle, prompts, max_new, **kw):
    svc = QuorumService(pool, bundle, n_slots=2, max_len=32, **kw)
    with torch.inference_mode():
        return svc.generate(prompts, max_new=max_new), svc


@pytest.mark.parametrize("attack", ["lie", "reversed"])
def test_service_token_identity_with_byzantine_replica(bundle, tparams,
                                                       attack):
    prompts = [[3, 5, 7], [11, 2, 4], [9, 9, 1]]   # 3 requests, 2 slots
    base, _ = _serve(ReplicaPool.from_params(tparams, 1, f=0), bundle,
                     prompts, 5)
    pool = ReplicaPool.from_params(tparams, R, f=F).corrupt(
        ByzantineSpec(server_attack=attack, n_byz_servers=1))
    outs, svc = _serve(pool, bundle, prompts, 5)
    assert outs == base
    rep = svc.report()
    assert rep["refills"] >= 1
    assert [i for _, i in rep["ejections"]] == [R - 1]
    assert rep["n_active"] == R - 1
    assert rep["requests"]["done"] == 3


def test_service_median_read_computes_the_median_once(bundle, tparams,
                                                      monkeypatch):
    """A median read reuses the detector's answer for its tokens; the median
    runs again only on the retry after an ejection."""
    calls = []
    inner = quorum.quorum_logits
    monkeypatch.setattr(quorum, "quorum_logits",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    pool = ReplicaPool.from_params(tparams, R, f=F).corrupt(
        ByzantineSpec(server_attack="reversed", n_byz_servers=1))
    _, svc = _serve(pool, bundle, [[3, 5, 7], [11, 2, 4]], 5)
    assert svc.retries == 1
    assert len(calls) == svc.reads + svc.retries


def test_service_clean_run_never_ejects(bundle, tparams):
    outs, svc = _serve(ReplicaPool.from_params(tparams, R, f=F), bundle,
                       [[1, 2, 3]], 4, rule="vote")
    rep = svc.report()
    assert rep["ejections"] == [] and rep["disagreement_rate"] == 0.0
    assert len(outs[0]) == 4


def test_service_deadline_truncates(bundle, tparams):
    svc = QuorumService(ReplicaPool.from_params(tparams, 1, f=0), bundle,
                        n_slots=1, max_len=64)
    req = svc.submit([1, 2, 3], max_new=30, deadline_ms=0.0)
    with torch.inference_mode():
        while svc.step():
            pass
    assert req.status == "deadline"
    assert 0 < len(req.out_tokens) < 30
    assert svc.report()["requests"]["deadline"] == 1


def test_service_rejects_vlm_family(tparams):
    vlm = types.SimpleNamespace(cfg=types.SimpleNamespace(family="vlm"))
    with pytest.raises(ValueError, match="token-in"):
        QuorumService(ReplicaPool.from_params(tparams, 1, f=0), vlm)


def test_service_eject_heal_readmit_token_identical(bundle, tparams):
    prompts = [[3, 5, 7], [11, 2, 4]]
    base, _ = _serve(ReplicaPool.from_params(tparams, 1, f=0), bundle,
                     prompts, 5)
    pool = ReplicaPool.from_params(tparams, R, f=F).corrupt(
        ByzantineSpec(server_attack="lie", n_byz_servers=1))
    outs, svc = _serve(pool, bundle, prompts, 5)
    assert outs == base
    assert [i for _, i in svc.report()["ejections"]] == [R - 1]
    assert svc.readmit(R - 1)
    assert not svc.readmit(R - 1)
    assert svc.pool.n_active == R
    for k, v in svc.pool.single(R - 1)["blocks"]["attn"].items():
        assert torch.equal(v, tparams["blocks"]["attn"][k])
    with torch.inference_mode():
        assert svc.generate(prompts, max_new=5) == base
    rep = svc.report()
    assert rep["n_active"] == R and len(rep["ejections"]) == 1


@pytest.mark.parametrize("attack", ["lie", "reversed"])
@pytest.mark.parametrize("rule", ["median", "vote"])
def test_jax_and_port_services_generate_identical_tokens(rule, attack):
    """The slice end to end: same numpy params (f32 activations), same
    prompts, one corrupted replica in both pools — the JAX QuorumService
    and the port's commit the same tokens and eject the same replica."""
    over = dict(act_dtype="float32")
    jb = jax_bundle("phi4-mini-3.8b", reduced=True, **over)
    tb = get_bundle("phi4-mini-3.8b", reduced=True, **over)
    p_np = numpy_params(jb.cfg, seed=5)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, jb.cfg.vocab, n).tolist() for n in (4, 9, 6)]
    spec_kw = dict(server_attack=attack, n_byz_servers=1)

    from repro.core.attacks import ByzantineSpec as JaxSpec
    jpool = JaxReplicaPool.from_params(jax_tree(p_np), R, f=F).corrupt(
        JaxSpec(**spec_kw), jax.random.PRNGKey(0))
    jsvc = JaxQuorumService(jpool, jb, n_slots=2, max_len=32, rule=rule)
    jout = jsvc.generate(prompts, max_new=6)

    tpool = ReplicaPool.from_params(
        params_from_jax(p_np, tb.cfg, device=CPU), R, f=F).corrupt(
        ByzantineSpec(**spec_kw))
    tout, tsvc = _serve(tpool, tb, prompts, 6, rule=rule)
    assert tout == jout
    assert ([i for _, i in tsvc.report()["ejections"]]
            == [i for _, i in jsvc.report()["ejections"]])


def test_jax_checkpoint_served_token_identical_to_the_jax_service(tmp_path):
    """A replica-stacked JAX checkpoint of the reduced transformer (f32
    activations; four equal replicas, the last one reversed): restored by
    each package's ``ReplicaPool.from_checkpoint`` (the replica count from
    the manifest) and served by each ``QuorumService``, the two commit the
    same tokens and eject the same replica."""
    import jax.numpy as jnp

    from repro.checkpoint import checkpointer as jck
    from repro.core import protocol as jproto
    from repro_torch.serve import checkpoint_groups
    over = dict(act_dtype="float32")
    jb = jax_bundle("phi4-mini-3.8b", reduced=True, **over)
    tb = get_bundle("phi4-mini-3.8b", reduced=True, **over)
    p_np = numpy_params(jb.cfg, seed=7)

    def stack(a):
        s = np.stack([a] * R)
        s[-1] = -s[-1]
        return jnp.asarray(s)

    d = str(tmp_path / "ck")
    jck.save(d, 5, jproto.ByzState(
        params=jax.tree.map(stack, p_np), t=jnp.asarray(5, jnp.int32),
        key=jax.random.PRNGKey(0)))
    assert checkpoint_groups(d) == (5, R)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, jb.cfg.vocab, n).tolist() for n in (5, 8, 3)]

    jpool = JaxReplicaPool.from_checkpoint(d, jb.init, f=F)
    jsvc = JaxQuorumService(jpool, jb, n_slots=2, max_len=32)
    jout = jsvc.generate(prompts, max_new=6)

    tpool = ReplicaPool.from_checkpoint(d, tb.init, f=F, device="cpu")
    assert tpool.n_replicas == R
    for k, v in tpool.single(0)["blocks"]["attn"].items():
        np.testing.assert_array_equal(v.numpy(),
                                      p_np["blocks"]["attn"][k])
    tout, tsvc = _serve(tpool, tb, prompts, 6)
    assert tout == jout
    assert ([i for _, i in tsvc.report()["ejections"]]
            == [i for _, i in jsvc.report()["ejections"]] == [R - 1])
    with pytest.raises(ValueError, match="another model"):
        ReplicaPool.from_checkpoint(d, get_bundle("phi4-mini-3.8b",
                                                  reduced=True,
                                                  d_model=64).init,
                                    f=F, device="cpu")

"""The port's ByzSGD training loop against the JAX package's, on the CPU.

Both simulators start from the same state (``sim_state_from_jax``), replay
the same quorums (``TraceDelivery`` index tables drawn with numpy) and take
the same numpy batches; params, worker state and metrics are compared after
more than 2T steps, async and sync. Then the port's fused runner against its
stepwise loop (exactly), and the modules under the loop: attacks, filters,
quorum tables, schedules, the MLP problem and the data stream.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_models as jmodels
from repro.core import attacks as jattacks
from repro.core import filters as jfilters
from repro.core import simulator as jsim
from repro.core.quorum import TraceDelivery as JTraceDelivery
from repro.optim import schedules as jsched
from repro_torch.configs import paper_models as tmodels
from repro_torch.core import attacks as tattacks
from repro_torch.core import filters as tfilters
from repro_torch.core import simulator as tsim
from repro_torch.core.engine import EpochEngine
from repro_torch.core.quorum import (TraceDelivery, UniformDelivery,
                                     validate_counts)
from repro_torch.data.pipeline import (DeviceBatchStream, MixtureSpec,
                                       classification_stream)
from repro_torch.models.convert import mlp_params_from_jax, sim_state_from_jax
from repro_torch.optim import schedules as tsched

DIM, HIDDEN, CLASSES, BATCH = 6, 8, 3, 5
# f32 sums run in other orders in the two packages (XLA vs PyTorch CPU); the
# differences grow over the steps but stay near 1e-6 of the weights
RTOL, ATOL = 2e-4, 2e-5


def _tables(rng, steps, T, n_w, n_ps, q_w, q_ps):
    """Numpy quorum tables: distinct senders per receiver; a server's gather
    quorum holds itself first."""
    def pick(n_recv, n_send, q, self_first=False):
        out = np.empty((n_recv, q), np.int32)
        for r in range(n_recv):
            if self_first:
                others = rng.permutation([s for s in range(n_send) if s != r])
                out[r] = np.concatenate([[r], others[:q - 1]])
            else:
                out[r] = rng.permutation(n_send)[:q]
        return out

    pull = np.stack([pick(n_w, n_ps, q_ps) for _ in range(steps)])
    push = np.stack([pick(n_ps, n_w, q_w) for _ in range(steps)])
    gather = np.stack([pick(n_ps, n_ps, q_ps, True)
                       for _ in range(max(steps // T, 1))])
    return pull, push, gather


def _batches(rng, steps, n_w):
    x = rng.standard_normal((steps, n_w, BATCH, DIM)).astype(np.float32)
    y = rng.integers(0, CLASSES, (steps, n_w, BATCH)).astype(np.int32)
    x += 1.5 * np.eye(CLASSES, DIM, dtype=np.float32)[y]
    return x, y


def _both(cfg_kw, steps, seed=0):
    """The JAX and the port's simulator on shared tables, batches and
    initial state; returns (JAX final state, port final state, port sim,
    batches)."""
    rng = np.random.default_rng(seed)
    jcfg = jsim.ByzSGDConfig(**cfg_kw)
    tcfg = tsim.ByzSGDConfig(**{**cfg_kw, "byz": tattacks.ByzantineSpec(
        **vars(cfg_kw["byz"]))})
    tables = _tables(rng, steps, jcfg.T, jcfg.n_workers, jcfg.n_servers,
                     jcfg.q_workers, jcfg.q_servers)
    x, y = _batches(rng, steps, jcfg.n_workers)
    jinit, jloss, _ = jmodels.make_mlp_problem(DIM, HIDDEN, CLASSES)
    tinit, tloss, _ = tmodels.make_mlp_problem(DIM, HIDDEN, CLASSES)
    lr = dict(eta0=0.2, decay=0.05)
    js = jsim.ByzSGDSimulator(jcfg, jinit, jloss, jsched.inverse_linear(**lr),
                              delivery=JTraceDelivery(*tables, T=jcfg.T))
    ts = tsim.ByzSGDSimulator(tcfg, tinit, tloss, tsched.inverse_linear(**lr),
                              delivery=TraceDelivery(*tables, T=tcfg.T),
                              device="cpu")
    j0 = js.init_state(jax.random.PRNGKey(seed))
    t0 = sim_state_from_jax(jax.tree.map(np.asarray, j0), tcfg, "cpu")
    jend, _ = js.run(j0, [(jnp.asarray(x[i]), jnp.asarray(y[i]))
                          for i in range(steps)])
    tend, _ = ts.run(t0, [(torch.from_numpy(x[i]), torch.from_numpy(y[i]))
                          for i in range(steps)])
    return jend, tend, ts, (x, y)


def _flat(tree_of_jax, sim):
    return sim.tree.flatten({k: torch.from_numpy(np.asarray(v))
                             for k, v in tree_of_jax.items()}, lead=1)


ALIE2 = dict(worker_attack="alie", n_byz_workers=2)


@pytest.mark.parametrize("server_attack", ["reversed", "lie"])
def test_async_stepwise_matches_jax(server_attack):
    """Async, 7 steps with T = 3 (two gathers and a tail): ALIE workers and
    a Byzantine server, both equivocating; MDA at the servers, Median
    pulls and DMC gathers."""
    cfg = dict(n_workers=7, f_workers=2, n_servers=5, f_servers=1, T=3,
               byz=jattacks.ByzantineSpec(server_attack=server_attack,
                                          n_byz_servers=1, equivocate=True,
                                          **ALIE2))
    jend, tend, ts, _ = _both(cfg, steps=7)
    assert tend.t == int(jend.t) == 7
    torch.testing.assert_close(tend.params, _flat(jend.params, ts),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(tend.w_grad, _flat(jend.w_grad, ts),
                               rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(tend.anchor_gnorm,
                               torch.tensor(float(jend.anchor_gnorm)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("gar,worker_gar", [("mda", "meamed"),
                                            ("trimmed_mean", "median")])
def test_sync_stepwise_matches_jax(gar, worker_gar):
    """Sync with the Lipschitz and Outliers filters, 7 steps with T = 3: a
    reversed server equivocating (its candidates get rejected), MeaMed or
    Median refresh at the gathers; rejects and the Lipschitz history
    (the first probe's coefficient, recorded unconditionally) match."""
    cfg = dict(n_workers=5, f_workers=1, n_servers=5, f_servers=1, T=3,
               variant="sync", gar=gar, worker_gar=worker_gar,
               lip_horizon=8,
               byz=jattacks.ByzantineSpec(server_attack="reversed",
                                          n_byz_servers=1, equivocate=True))
    jend, tend, ts, _ = _both(cfg, steps=7)
    for got, want in ((tend.params, jend.params),
                      (tend.w_model, jend.w_model),
                      (tend.w_grad, jend.w_grad)):
        torch.testing.assert_close(got, _flat(want, ts), rtol=RTOL,
                                   atol=ATOL)
    torch.testing.assert_close(tend.lip.buf, torch.from_numpy(
        np.asarray(jend.lip.buf)), rtol=RTOL, atol=ATOL, equal_nan=True)
    assert torch.equal(tend.lip.idx, torch.from_numpy(
        np.asarray(jend.lip.idx)).long())


def _port_sim(variant, steps, byz):
    rng = np.random.default_rng(3)
    n_w = 7 if variant == "async" else 5
    cfg = tsim.ByzSGDConfig(n_workers=n_w, f_workers=2 if n_w == 7 else 1,
                            n_servers=5, f_servers=1, T=3, variant=variant,
                            byz=byz)
    init, loss, acc = tmodels.make_mlp_problem(DIM, HIDDEN, CLASSES)
    sim = tsim.ByzSGDSimulator(cfg, init, loss,
                               tsched.inverse_linear(0.2, 0.05),
                               delivery=TraceDelivery(*_tables(
                                   rng, steps, 3, n_w, 5, cfg.q_workers,
                                   cfg.q_servers), T=3),
                               device="cpu")
    x, y = _batches(rng, steps, n_w)
    return sim, acc, torch.from_numpy(x), torch.from_numpy(y)


@pytest.mark.parametrize("variant", ["async", "sync"])
@pytest.mark.parametrize("epoch_steps", [2, 3, 7])
def test_fused_equals_stepwise_exactly(variant, epoch_steps):
    """Any epoch length, a tail with steps % T != 0 included: the same
    params bit for bit, the strided acc buffer (0 off the stride) equal to
    the stepwise loop's logged acc, the sync rejects equal."""
    steps = 7
    byz = tattacks.ByzantineSpec(server_attack="reversed", n_byz_servers=1,
                                 equivocate=True, **ALIE2) \
        if variant == "async" else tattacks.ByzantineSpec(
            server_attack="reversed", n_byz_servers=1, equivocate=True)
    sim, acc, x, y = _port_sim(variant, steps, byz)
    ex, ey = x[0, 0], y[0, 0]

    def acc_flat(flat, a, b):
        return acc(sim.tree.unflatten(flat), a, b)

    s0 = sim.init_state(0)
    ref, logs = sim.run(s0, [(x[i], y[i]) for i in range(steps)],
                        metrics_fn=lambda s: {"acc": float(acc_flat(
                            s.params[0], ex, ey))}, metrics_every=2)
    eng = EpochEngine(sim, acc_fn=acc_flat, eval_set=(ex, ey),
                      track_delta=True, metrics_every=2)
    got, buf = eng.run(sim.init_state(0), (x, y), epoch_steps=epoch_steps)
    assert torch.equal(got.params, ref.params)
    assert torch.equal(got.w_model, ref.w_model)
    assert got.t == ref.t == steps
    np.testing.assert_array_equal(buf["acc"][::2], [m["acc"] for m in logs])
    assert np.all(buf["acc"][1::2] == 0)
    assert buf["delta"].shape == (steps,) and np.all(buf["l2_diam"] >= 0)
    if variant == "sync":
        assert buf["rejects"].shape == (steps, 5)


# -- the modules under the loop ------------------------------------------------

def _honest(n=6, d=40, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


@pytest.mark.parametrize("name", ["reversed", "alie", "sign_flip", "zero"])
def test_gradient_attacks_match_jax(name):
    """Deterministic attacks exactly as the JAX package (ALIE's std with
    ddof 0), with and without equivocation."""
    x = _honest()
    spec_kw = dict(worker_attack=name, n_byz_workers=2)
    for n_recv in (None, 3):
        want = jattacks.inject_gradients(
            jnp.asarray(x), jattacks.ByzantineSpec(**spec_kw),
            jax.random.PRNGKey(0), n_receivers=n_recv)
        got = tattacks.inject_gradients(
            torch.from_numpy(x), tattacks.ByzantineSpec(**spec_kw), None,
            n_receivers=n_recv)
        assert tuple(got.shape) == tuple(want.shape)
        torch.testing.assert_close(got, torch.from_numpy(np.asarray(want)),
                                   rtol=1e-6, atol=1e-6)
    assert tattacks.alie_zmax(9, 2) == jattacks.alie_zmax(9, 2)


def test_random_attack_norm_matched_per_leaf():
    """On a flat stack with its tree, random's scale is matched leaf by leaf
    (the JAX package's per-leaf injection)."""
    init, _, _ = tmodels.make_mlp_problem(DIM, HIDDEN, CLASSES)
    tree = tsim.FlatTree.from_params(init(torch.Generator().manual_seed(0)))
    x = torch.from_numpy(_honest(5, tree.size))
    x[:, :tree.sizes[0]] *= 100.0                 # one loud leaf
    spec = tattacks.ByzantineSpec(server_attack="random", n_byz_servers=1)
    out = tattacks.inject_models(x, spec, torch.Generator().manual_seed(1),
                                 tree=tree)
    for off, size in tree.spans():
        m = x[:4, off:off + size].mean(0)
        want = torch.linalg.vector_norm(m) / size ** 0.5
        got = out[4, off:off + size]
        assert 0.3 * want < got.abs().mean() < 3 * want


def test_filters_match_jax():
    rng = np.random.default_rng(1)
    buf = rng.random((4, 8)).astype(np.float32)
    buf[0] = np.nan                      # an empty history accepts all
    buf[1, 5:] = np.nan
    idx = np.array([0, 5, 8, 9])
    got = tfilters.lipschitz_cutoff(tfilters.LipschitzHistory(
        torch.from_numpy(buf), torch.from_numpy(idx)), 5, 1)
    for w in range(4):
        want = jfilters.lipschitz_cutoff(jfilters.LipschitzHistory(
            jnp.asarray(buf[w]), jnp.asarray(idx[w])), 5, 1)
        np.testing.assert_allclose(got[w], want, rtol=1e-6, equal_nan=True)
    assert np.isnan(got[0])
    for t in (0, 1, 5, 7):
        np.testing.assert_allclose(
            tfilters.outliers_bound(t, 3, torch.tensor(0.1),
                                    torch.tensor(2.0), 5, 1),
            jfilters.outliers_bound(jnp.int32(t), 3, jnp.float32(0.1),
                                    jnp.float32(2.0), 5, 1), rtol=1e-6)
    a, b, c, d = (_honest(1, 30, s)[0] for s in range(4))
    np.testing.assert_allclose(
        tfilters.lipschitz_coefficient(*map(torch.from_numpy, (a, b, c, d))),
        jfilters.lipschitz_coefficient(a, b, c, d), rtol=1e-6)
    hist = tfilters.LipschitzHistory.create(2, 3).push(torch.tensor([1., 2.]))
    assert hist.buf[1, 0] == 2.0 and torch.isnan(hist.buf[0, 1])
    assert hist.idx.tolist() == [1, 1]


def test_quorum_models():
    g = torch.Generator().manual_seed(0)
    u = UniformDelivery(9, 5, 7, 4)
    pull, gather = u.pull_indices(g, 0), u.gather_indices(g, 0)
    assert pull.shape == (9, 4) and gather.shape == (5, 4)
    assert all(len(set(r.tolist())) == 4 for r in pull)
    assert torch.equal(gather[:, 0], torch.arange(5))   # self delivered
    tables = _tables(np.random.default_rng(0), 6, 3, 5, 5, 4, 4)
    tr, jt = TraceDelivery(*tables, T=3), JTraceDelivery(*tables, T=3)
    for t in (0, 3, 6, 8):
        np.testing.assert_array_equal(tr.pull_indices(None, t),
                                      jt.pull_indices(None, jnp.int32(t)))
        np.testing.assert_array_equal(tr.gather_indices(None, t),
                                      jt.gather_indices(None, jnp.int32(t)))
    with pytest.raises(ValueError, match="3f_w"):
        validate_counts(6, 2, 5, 1, 4, 4)
    with pytest.raises(ValueError, match="3f_ps"):
        validate_counts(7, 2, 4, 1, 5, 3)


def test_schedules_and_mlp_match_jax():
    for name, kw in (("inverse_linear", dict(eta0=0.05, decay=0.005)),
                     ("inverse_sqrt", dict(eta0=0.1)),
                     ("constant", dict(eta0=0.02))):
        tl, jl = getattr(tsched, name)(**kw), getattr(jsched, name)(**kw)
        for t in (0, 1, 17, 149):
            assert tl(t) == float(np.float32(jl(jnp.int32(t))))
    jp = jmodels.mlp_init(jax.random.PRNGKey(0), DIM, HIDDEN, CLASSES)
    tp = mlp_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x, y = _batches(np.random.default_rng(2), 1, 1)
    xb, yb = x[0, 0], y[0, 0]
    jl, jg = jax.value_and_grad(jmodels.mlp_loss)(
        jp, (jnp.asarray(xb), jnp.asarray(yb)))
    tree = tsim.FlatTree.from_params(tp)
    theta = tree.flatten(tp).requires_grad_(True)
    tl = tmodels.mlp_loss(tree.unflatten(theta),
                          (torch.from_numpy(xb), torch.from_numpy(yb)))
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    jflat = np.concatenate([np.asarray(l).ravel()
                            for l in jax.tree.leaves(jg)])
    np.testing.assert_allclose(theta.grad.numpy(), jflat, rtol=1e-5,
                               atol=1e-7)
    assert tree.paths == [(k,) for k in sorted(jp)]
    np.testing.assert_allclose(
        tmodels.mlp_accuracy(tp, torch.from_numpy(xb), torch.from_numpy(yb)),
        jmodels.mlp_accuracy(jp, xb, yb))


def test_device_stream_matches_stepwise_stream():
    """Any epoch lengths give the stepwise stream's batches; the eval set
    has its own seed."""
    spec = MixtureSpec(n_classes=5, dim=16, sep=2.5)
    s = DeviceBatchStream(0, spec, 3, 4)
    x1, y1 = s.next(2)
    x2, y2 = s.next(3)
    host, eval_fn = classification_stream(0, spec, 3, 4, 5)
    hx, hy = zip(*host)
    assert torch.equal(torch.cat([x1, x2]), torch.stack(hx))
    assert torch.equal(torch.cat([y1, y2]), torch.stack(hy))
    ex, ey = eval_fn(64)
    assert ex.shape == (64, 16) and torch.equal(ey, s.eval_set(64)[1])

"""The port's distributed ByzSGD protocol (one device, no mesh) against the
JAX package's, on the CPU.

Both ``ProtocolEngine``s start from one state (``protocol_state_from_jax``),
replay the same quorums (``TraceDelivery`` tables drawn with numpy) and take
the same numpy batches; params are compared after 2T + 1 steps at T = 3 for
the reduced dense transformer in float32 and for an MLP problem, async
(median pull) and sync (round-robin pull). Then the port's protocol against
its own single-host ``EpochEngine``, and the modules under the protocol:
the transformer's loss and grads, the chunked cross-entropy, the token
stream's law, ``selection_weights``, the optimizer registry, the masked
pull, ``consolidate`` and ``collective_volume_bytes``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, jax_tree, numpy_params
from repro import agg as jagg
from repro import optim as joptim
from repro.configs import paper_models as jmodels
from repro.core import attacks as jattacks
from repro.core import protocol as jproto
from repro.core.quorum import TraceDelivery as JTraceDelivery
from repro.data import pipeline as jpipe
from repro.models import layers as jlayers
from repro.models.registry import get_bundle as jax_bundle
from repro.optim import schedules as jsched
from repro_torch import agg, optim
from repro_torch.configs import paper_models as tmodels
from repro_torch.core import attacks as tattacks
from repro_torch.core import protocol as tproto
from repro_torch.core import simulator as tsim
from repro_torch.core.engine import EpochEngine
from repro_torch.core.quorum import TraceDelivery
from repro_torch.data import pipeline as tpipe
from repro_torch.models import layers as tlayers
from repro_torch.models.convert import params_from_jax, protocol_state_from_jax
from repro_torch.models.registry import get_bundle
from repro_torch.optim import schedules as tsched

# f32 sums run in other orders in the two packages (XLA vs PyTorch CPU);
# the differences grow over the steps but stay near 1e-6 of the weights
RTOL, ATOL = 2e-4, 2e-5
T, STEPS = 3, 7                       # 2T + 1 steps: two gathers and a tail


def _tables(rng, steps, G, q_w, q_ps):
    """Numpy quorum tables: distinct senders per receiver; a server's gather
    quorum holds itself first."""
    def pick(q, self_first=False):
        out = np.empty((G, q), np.int32)
        for r in range(G):
            if self_first:
                others = rng.permutation([s for s in range(G) if s != r])
                out[r] = np.concatenate([[r], others[:q - 1]])
            else:
                out[r] = rng.permutation(G)[:q]
        return out

    pull = np.stack([pick(q_ps) for _ in range(steps)])
    push = np.stack([pick(q_w) for _ in range(steps)])
    gather = np.stack([pick(q_ps, True) for _ in range(steps // T)])
    return pull, push, gather


def _pcfgs(**kw):
    byz = kw.pop("byz", None)
    jp = jproto.ProtocolConfig.derive(
        kw.pop("G"), T=T, byz=jattacks.ByzantineSpec(**(byz or {})), **kw)
    tp = tproto.ProtocolConfig(**{**vars(jp), "byz": tattacks.ByzantineSpec(
        **vars(jp.byz))})
    return jp, tp


def _run_both(jbundle, tbundle, jp, tp, batches_np, seed=0, lr=(0.2, 0.05)):
    """Both engines for STEPS steps on shared tables, batches and initial
    state; returns (JAX final state, port final state)."""
    rng = np.random.default_rng(seed)
    tables = _tables(rng, STEPS, jp.n_groups, jp.q_workers, jp.q_servers)
    attack = bool(jp.byz.worker_attack or jp.byz.server_attack)
    jeng = jproto.ProtocolEngine(
        jbundle, jp, jsched.inverse_linear(*lr),
        delivery=JTraceDelivery(*tables, T=T), with_attack=attack)
    teng = tproto.ProtocolEngine(
        tbundle, tp, tsched.inverse_linear(*lr),
        delivery=TraceDelivery(*tables, T=T, device="cpu"),
        with_attack=attack,
        device="cpu")
    j0 = jeng.init_state(jax.random.PRNGKey(seed))
    t0 = protocol_state_from_jax(jax.tree.map(np.asarray, j0), "cpu")
    if isinstance(batches_np, dict):
        jb = {k: jnp.asarray(v) for k, v in batches_np.items()}
        tb = {k: torch.from_numpy(v).long() for k, v in batches_np.items()}
    else:
        jb = tuple(jnp.asarray(v) for v in batches_np)
        tb = (torch.from_numpy(batches_np[0]),
              torch.from_numpy(batches_np[1]).long())
    jend, _ = jeng.run(j0, jb)
    tend, _ = teng.run(t0, tb)
    return jend, tend


def _assert_params_close(jend, tend):
    want = protocol_state_from_jax(jax.tree.map(np.asarray, jend), "cpu")
    assert tend.t == want.t == STEPS
    torch.testing.assert_close(tend.params, want.params, rtol=RTOL,
                               atol=ATOL)


def test_tfm_tiny_protocol_matches_jax():
    """The reduced dense transformer (hd 32, 2 layers) in float32, G = 4
    groups, f_w = 1 with an ALIE worker, MDA over q_w = 3 of 4, Median pulls
    of all 4 replicas, DMC gathers; 7 steps at T = 3."""
    over = dict(act_dtype="float32")
    jb = jax_bundle("phi4-mini-3.8b", reduced=True, **over)
    tb = get_bundle("phi4-mini-3.8b", reduced=True, **over)
    jp, tp = _pcfgs(G=4, byz=dict(worker_attack="alie", n_byz_workers=1))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jb.cfg.vocab, (STEPS, 4, 2, 17)).astype(np.int32)
    batches = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    jend, tend = _run_both(jb, tb, jp, tp, batches, lr=(0.05, 0.05))
    _assert_params_close(jend, tend)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "rwkv6-3b"])
def test_zoo_protocol_matches_jax_every_selection(arch, monkeypatch):
    """``lm/moe_tiny``'s and ``lm/rwkv_tiny``'s models (f32 activations;
    the MoE keeps qwen3-moe's bf16 replicas) through both ``ProtocolEngine``s
    on replayed tables and numpy batches, G = 4 with an ALIE worker, 7
    steps at T = 3: every step's MDA selection equal (the quorum weights of
    every server), and params within the float32 tolerance (the MoE's bf16
    replicas within one bf16 step: an update can round to a neighbouring
    bf16 value)."""
    sel = {"jax": [], "port": []}
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

    monkeypatch.setattr(jproto, "quorum_weights", jrec)
    monkeypatch.setattr(tproto, "quorum_weights", trec)
    over = dict(act_dtype="float32")
    jb = jax_bundle(arch, reduced=True, **over)
    tb = get_bundle(arch, reduced=True, **over)
    jp, tp = _pcfgs(G=4, byz=dict(worker_attack="alie", n_byz_workers=1))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jb.cfg.vocab, (STEPS, 4, 2, 17)).astype(np.int32)
    batches = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    jend, tend = _run_both(jb, tb, jp, tp, batches, lr=(0.05, 0.05))
    assert len(sel["jax"]) == len(sel["port"]) == STEPS
    for a, b in zip(sel["jax"], sel["port"]):
        np.testing.assert_array_equal(b > 0, a > 0)
        np.testing.assert_allclose(b, a, rtol=1e-6)
    want = protocol_state_from_jax(jax.tree.map(np.asarray, jend), "cpu")
    assert tend.params.dtype == want.params.dtype == (
        torch.bfloat16 if "moe" in arch else torch.float32)
    tol = (dict(rtol=2 ** -7, atol=2 ** -12) if "moe" in arch
           else dict(rtol=RTOL, atol=ATOL))
    torch.testing.assert_close(tend.params, want.params, **tol)


MIX_DIM, HIDDEN, CLASSES, BATCH = 6, 8, 3, 5


def _mlp_batches(rng, steps, G):
    x = rng.standard_normal((steps, G, BATCH, MIX_DIM)).astype(np.float32)
    y = rng.integers(0, CLASSES, (steps, G, BATCH)).astype(np.int32)
    x += 1.5 * np.eye(CLASSES, MIX_DIM, dtype=np.float32)[y]
    return x, y


def _mlp_bundles():
    jinit, jloss, _ = jmodels.make_mlp_problem(MIX_DIM, HIDDEN, CLASSES)
    tinit, tloss, _ = tmodels.make_mlp_problem(MIX_DIM, HIDDEN, CLASSES)
    return (jproto.ProblemBundle(init=jinit, loss=jloss),
            tproto.ProblemBundle(init=tinit, loss=tloss))


@pytest.mark.parametrize("pull,byz,micro", [
    ("median", dict(worker_attack="alie", n_byz_workers=1,
                    server_attack="reversed", n_byz_servers=1), 1),
    ("roundrobin", dict(server_attack="lie", n_byz_servers=1), 1),
    ("median", dict(worker_attack="sign_flip", n_byz_workers=1), 2),
])
def test_mlp_protocol_matches_jax(pull, byz, micro):
    """An MLP problem on G = 5 groups (f_w = f_ps = 1): the async median
    pull under ALIE workers and a reversed server, the sync §5 round-robin
    pull with its distance filter under a LIE server, and gradients
    averaged over two micro-batches (batch leaves ``[steps, micro, G,
    ...]``)."""
    jb, tb = _mlp_bundles()
    jp, tp = _pcfgs(G=5, f_workers=1, f_servers=1, pull=pull, byz=byz,
                    grad_microbatches=micro)
    x, y = _mlp_batches(np.random.default_rng(2), STEPS * micro, 5)
    if micro > 1:
        x = x.reshape((STEPS, micro) + x.shape[1:])
        y = y.reshape((STEPS, micro) + y.shape[1:])
    jend, tend = _run_both(jb, tb, jp, tp, (x, y))
    _assert_params_close(jend, tend)


@pytest.mark.parametrize("steps,epoch_steps", [(7, None), (10, 4)])
def test_protocol_matches_the_ports_epoch_engine(steps, epoch_steps):
    """Mirrors tests/test_protocol_engine.py in the port: on a G = n_w =
    n_ps cluster the protocol's scatter/gather steps are the single-host
    simulator's, so the two engines agree on shared quorum tables, batches
    and initial state (params allclose, accuracy buffers equal), whatever
    the epoch chunking."""
    G = 5
    cfg = tsim.ByzSGDConfig(n_workers=G, f_workers=1, n_servers=G,
                            f_servers=1, T=T)
    tp = tproto.ProtocolConfig.derive(
        G, T=T, f_workers=1, f_servers=1, q_workers=cfg.q_workers,
        q_servers=cfg.q_servers)
    rng = np.random.default_rng(3)
    tables = _tables(rng, steps, G, cfg.q_workers, cfg.q_servers)
    x, y = _mlp_batches(rng, steps, G)
    batches = (torch.from_numpy(x), torch.from_numpy(y).long())
    tinit, tloss, acc = tmodels.make_mlp_problem(MIX_DIM, HIDDEN, CLASSES)
    ev = (batches[0][0, 0], batches[1][0, 0])
    lr = tsched.inverse_linear(0.2, 0.05)
    sim = tsim.ByzSGDSimulator(cfg, tinit, tloss, lr,
                               delivery=TraceDelivery(*tables, T=T,
                                                      device="cpu"),
                               device="cpu")
    flat0 = sim.tree.flatten(tinit(torch.Generator().manual_seed(0)))
    s_sim, m_sim = EpochEngine(
        sim, acc_fn=lambda p, *e: acc(sim.tree.unflatten(p), *e),
        eval_set=ev).run(sim.state_from(flat0, torch.Generator()), batches,
                         epoch_steps=epoch_steps)
    eng = tproto.ProtocolEngine(tproto.ProblemBundle(tinit, tloss), tp, lr,
                                delivery=TraceDelivery(*tables, T=T,
                                                       device="cpu"),
                                acc_fn=acc, eval_set=ev, device="cpu")
    s0 = tproto.ByzState(flat0.expand(G, -1).clone(), 0, torch.Generator(),
                         (), sim.tree)
    s_pro, m_pro = eng.run(s0, batches, epoch_steps=epoch_steps)
    assert s_pro.t == s_sim.t == steps
    torch.testing.assert_close(s_pro.params, s_sim.params, rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_array_equal(m_pro["acc"], m_sim["acc"])


# ---------------------------------------------------------------------------
# modules under the protocol
# ---------------------------------------------------------------------------


def test_transformer_loss_and_grads_match_jax():
    """The reduced transformer's chunked-CE loss and its grads w.r.t. every
    leaf, f32 activations, remat on: rtol 1e-4 (f32 in other summation
    orders)."""
    over = dict(act_dtype="float32", q_block=8, kv_block=8)
    jb = jax_bundle("phi4-mini-3.8b", reduced=True, **over)
    tb = get_bundle("phi4-mini-3.8b", reduced=True, **over)
    p_np = numpy_params(jb.cfg, seed=4)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jb.cfg.vocab, (2, 21)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jl, jg = jax.value_and_grad(jb.loss)(
        jax_tree(p_np), {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_jax(p_np, tb.cfg, device=CPU)
    leaves = []

    def req(t):
        if isinstance(t, dict):
            return {k: req(v) for k, v in t.items()}
        leaves.append(t.requires_grad_())
        return t

    tp = req(tp)
    tl = tb.loss(tp, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    flat_j = jax.tree_util.tree_leaves_with_path(jg)
    for path, g in flat_j:
        node = tp
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node.grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


def test_cross_entropy_chunked_matches_jax_with_a_ragged_tail():
    """S = 40 in chunks of 16 (a ragged last chunk), and the full-logits
    cross_entropy: the loss and the hidden/table grads."""
    rng = np.random.default_rng(6)
    h = rng.standard_normal((2, 40, 24)).astype(np.float32)
    table = (0.3 * rng.standard_normal((50, 24))).astype(np.float32)
    lab = rng.integers(0, 50, (2, 40)).astype(np.int32)

    def jfn(h, t):
        return jlayers.cross_entropy_chunked(h, {"table": t}, lab, chunk=16)

    jl, (jgh, jgt) = jax.value_and_grad(jfn, argnums=(0, 1))(h, table)
    th = torch.from_numpy(h).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    tl = tlayers.cross_entropy_chunked(th, {"table": tt},
                                       torch.from_numpy(lab).long(), chunk=16)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgt), rtol=1e-4,
                               atol=1e-7)
    logits = np.einsum("bsd,vd->bsv", h, table)
    np.testing.assert_allclose(
        tlayers.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(lab)).item(),
        float(jlayers.cross_entropy(jnp.asarray(logits), lab)), rtol=1e-5)


def test_token_stream_draws_the_jax_law():
    """Port and JAX token batches on one histogram: the same support
    [0, vocab), next-token labels, and the Zipf law p(rank) ∝ rank^-1.2 —
    each sampler's rank frequencies within 5 standard errors of the exact
    law on the 64 most frequent tokens, and the fitted exponent within 0.05
    of 1.2 for both."""
    spec = tpipe.TokenSpec(vocab=512, seq=64, zipf=1.2)
    n_steps, G, b = 20, 4, 8
    tb = tpipe.DeviceTokenStream(0, spec, G, b, "cpu").next(n_steps)
    jspec = jpipe.TokenSpec(vocab=512, seq=64, zipf=1.2)
    jb = jpipe.DeviceTokenStream(0, jspec, G, b).next(n_steps)
    assert tb["tokens"].shape == tuple(jb["tokens"].shape)
    assert torch.equal(tb["tokens"][..., 1:], tb["labels"][..., :-1])
    ranks = np.arange(1, spec.vocab + 1, dtype=np.float64)
    law = ranks ** -spec.zipf
    law /= law.sum()
    top = 64
    for toks in (tb["tokens"].numpy(), np.asarray(jb["tokens"])):
        assert toks.min() >= 0 and toks.max() < spec.vocab
        n = toks.size
        freq = np.bincount(toks.ravel(), minlength=spec.vocab) / n
        se = np.sqrt(law * (1 - law) / n)
        assert np.all(np.abs(freq[:top] - law[:top]) <= 5 * se[:top])
        slope = np.polyfit(np.log(ranks[:top]), np.log(freq[:top]), 1)[0]
        assert abs(-slope - spec.zipf) < 0.05
    # eval sets and the streamed sequence are deterministic per seed
    a = tpipe.DeviceTokenStream(0, spec, G, b, "cpu")
    c = list(tpipe.token_stream(0, spec.vocab, G, b, spec.seq, 3,
                                 device="cpu"))
    got = a.next(3)
    assert all(torch.equal(got["tokens"][i], c[i]["tokens"])
               for i in range(3))


@pytest.mark.parametrize("rule,n,f", [("mda", 6, 2), ("mda", 4, 1),
                                      ("krum", 7, 2), ("multi_krum", 7, 2)])
def test_selection_weights_match_jax(rule, n, f):
    """Weights of a selection rule from one [n, n] distance matrix and a
    batch of three: exact (the same selection, the same uniform weights)."""
    x = np.random.default_rng(n + f).standard_normal((3, n, 9))
    d2 = ((x[:, :, None] - x[:, None, :]) ** 2).sum(-1).astype(np.float32)
    got = agg.selection_weights(rule, torch.from_numpy(d2), f).numpy()
    for i in range(3):
        want = np.asarray(jagg.selection_weights(rule, jnp.asarray(d2[i]), f))
        np.testing.assert_array_equal(got[i], want)
    with pytest.raises(ValueError, match="not selection-based"):
        agg.selection_weights("median", torch.from_numpy(d2[0]), f)


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_optimizer_registry_matches_jax(name):
    """Three updates of a [G, P] stack: the same float32 arithmetic (rtol
    1e-6: AdamW's bias corrections are float32 powers in both)."""
    assert set(optim.OPTIMIZERS) == set(joptim.OPTIMIZERS)
    rng = np.random.default_rng(7)
    p = rng.standard_normal((3, 40)).astype(np.float32)
    jopt, topt = joptim.get(name), optim.get(name)
    jp, js = jnp.asarray(p), jopt.init(jnp.asarray(p))
    tp = torch.from_numpy(p.copy())
    ts = topt.init(tp)
    for i in range(3):
        g = rng.standard_normal((3, 40)).astype(np.float32)
        lr = tsched.inverse_linear(0.1, 0.01)(i)
        jp, js = jopt.update(jnp.asarray(g), js, jp, jnp.float32(lr))
        tp, ts = topt.update(torch.from_numpy(g.copy()), ts, tp, lr)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)
    with pytest.raises(KeyError, match="unknown optimizer"):
        optim.get("lion")


def test_masked_pull_and_consolidate_match_jax():
    """The masked Median pull (the gathered, batched route) in column
    chunks smaller than a replica, and the consolidated median; quorums of
    different sizes (one receiver delivering a replica fewer) give JAX's
    values too."""
    rng = np.random.default_rng(8)
    P = 1000
    params = rng.standard_normal((5, P)).astype(np.float32)
    jp, tp = _pcfgs(G=5, f_workers=1, f_servers=1)
    tp_small = tproto.ProtocolConfig(**{**vars(tp), "chunk_bytes": 4 * 333})
    jparams = {"w": jnp.asarray(params)}
    masks = np.array([[1, 1, 1, 1, 0], [0, 1, 1, 1, 1], [1, 0, 1, 1, 1],
                      [1, 1, 0, 1, 1], [1, 1, 1, 0, 1]], bool)
    mixed = masks.copy()
    mixed[0, 4] = True
    for m in (masks, mixed):
        want = np.asarray(jproto.masked_pull(jparams, jnp.asarray(m),
                                             jp)["w"])
        got = tproto.masked_pull(torch.from_numpy(params),
                                 torch.from_numpy(m), tp_small)
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jproto.consolidate(jparams, jp)["w"])
    got = tproto.consolidate(torch.from_numpy(params), tp_small)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=1e-7)


# ---------------------------------------------------------------------------
# quorums with a repeated sender (a netsim trace pads a starved quorum by
# repeating a delivered sender)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule", ["median", "meamed", "trimmed_mean"])
@pytest.mark.parametrize("gather", [False, True])
def test_masked_pull_with_unequal_counts_matches_jax(rule, gather):
    """Masks of counts [4, 3, 4, 4] (the second receiver's quorum repeats a
    sender): the worker pull ``[4 recv, 5 send]``, and the DMC gather
    ``[4, 4]`` written in place (``out`` aliases ``params``) in chunks
    smaller than a replica, against JAX's ``masked_pull`` on the same numpy
    stack. rtol 1e-6: the means sum in other orders."""
    rng = np.random.default_rng(20)
    P, G_send = 777, (4 if gather else 5)
    params = rng.standard_normal((G_send, P)).astype(np.float32)
    masks = np.ones((4, G_send), bool)
    if not gather:
        masks[:, 4] = False
        masks[[0, 2, 3], [3, 0, 1]] = [False, False, False]
        masks[[0, 2, 3], 4] = True
    masks[1, 2] = False
    assert masks.sum(1).tolist() == [4, 3, 4, 4]
    kw = dict(f_workers=1, f_servers=1, pull_gar=rule, gather_gar=rule)
    jp, tp = _pcfgs(G=5, **kw)
    tp = tproto.ProtocolConfig(**{**vars(tp), "chunk_bytes": 4 * 4 * 100})
    want = np.asarray(jproto.masked_pull(
        {"w": jnp.asarray(params)}, jnp.asarray(masks), jp, rule=rule)["w"])
    x = torch.from_numpy(params.copy())
    got = tproto.masked_pull(x, torch.from_numpy(masks), tp, rule=rule,
                             out=x if gather else None)
    if gather:
        assert got is x
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_quorum_weights_with_a_repeated_sender_match_jax():
    """Equidistant workers tie every MDA subset, so the first argmin keeps
    the first q - f quorum slots: where a sender's last copy falls outside
    them, one copy gets 1/(q - f) and the other 0. The weights scatter
    back with the last occurrence winning, bit-equal to JAX's
    ``.at[idx].set(w)``."""
    G = 5
    d2 = (np.ones((G, G)) - np.eye(G)).astype(np.float32)
    idx = np.array([[0, 1, 2, 0], [1, 0, 1, 2], [2, 3, 4, 1], [4, 4, 0, 1],
                    [3, 2, 1, 3]], np.int32)
    jp, tp = _pcfgs(G=G, f_workers=1, f_servers=1)
    want = np.asarray(jproto.quorum_weights(jnp.asarray(d2),
                                            jnp.asarray(idx), 1, jp))
    got = tproto.quorum_weights(torch.from_numpy(d2), torch.from_numpy(idx),
                                1, tp)
    np.testing.assert_array_equal(got.numpy(), want)
    # the case the repair is for: the dropped copy is the last one
    w = agg.selection_weights("mda", torch.from_numpy(
        d2[idx[:, :, None], idx[:, None, :]]), 1).numpy()
    assert w[0, 0] > 0 and w[0, 3] == 0 and want[0, 0] == 0


def _churn_tables():
    """The realized ``membership_churn`` trace of the G = 5 lm spec (12
    steps, T = 5), from the JAX package's netsim: push quorums repeat a
    sender from step 7 on and one DMC gather quorum of round 1 repeats
    one."""
    from repro import exp as jexp
    from repro.netsim import ClusterSim
    e = jexp.get("lm/tfm_tiny", delivery="trace", scenario="membership_churn",
                 n_workers=5, f_workers=1, n_servers=5, f_servers=1)
    tr = ClusterSim(e.to_scenario()).run()
    return e, (tr.pull_idx, tr.push_idx, tr.gather_idx)


def _repeats(a):
    return {(k, r) for k in range(a.shape[0]) for r in range(a.shape[1])
            if len(set(a[k, r].tolist())) < a.shape[2]}


def test_protocol_on_a_trace_with_repeated_senders_matches_jax():
    """Both ``ProtocolEngine``s (MLP problem, G = 5, f_w = f_ps = 1, T = 5)
    replay the ``membership_churn`` trace tables for 2T + 1 = 11 steps,
    through repeated push senders and a repeated sender in the DMC gather
    after step 10: params within the protocol tests' tolerance."""
    e, tables = _churn_tables()
    assert {k for k, _ in _repeats(tables[1])} & set(range(7, 11))
    assert 1 in {r for r, _ in _repeats(tables[2])}
    steps, T5 = 11, e.T
    jb, tb = _mlp_bundles()
    jp = jproto.ProtocolConfig.derive(5, T=T5, f_workers=1, f_servers=1)
    tp = tproto.ProtocolConfig(**{**vars(jp), "byz": tattacks.ByzantineSpec()})
    lr = (0.2, 0.05)
    jeng = jproto.ProtocolEngine(jb, jp, jsched.inverse_linear(*lr),
                                 delivery=JTraceDelivery(*tables, T=T5))
    teng = tproto.ProtocolEngine(tb, tp, tsched.inverse_linear(*lr),
                                 delivery=TraceDelivery(*tables, T=T5,
                                                        device="cpu"),
                                 device="cpu")
    x, y = _mlp_batches(np.random.default_rng(21), steps, 5)
    j0 = jeng.init_state(jax.random.PRNGKey(0))
    t0 = protocol_state_from_jax(jax.tree.map(np.asarray, j0), "cpu")
    jend, _ = jeng.run(j0, (jnp.asarray(x), jnp.asarray(y)))
    tend, _ = teng.run(t0, (torch.from_numpy(x), torch.from_numpy(y).long()))
    want = protocol_state_from_jax(jax.tree.map(np.asarray, jend), "cpu")
    assert tend.t == want.t == steps
    torch.testing.assert_close(tend.params, want.params, rtol=RTOL,
                               atol=ATOL)


def test_collective_volume_and_config_validation_match_jax():
    for G, K, xdt in ((4, 1, "float32"), (5, 2, "float32"),
                      (7, 1, "bfloat16")):
        jp = jproto.ProtocolConfig.derive(G, exchange_dtype=xdt)
        tp = tproto.ProtocolConfig.derive(G, exchange_dtype=xdt)
        assert vars(tp).keys() == vars(jp).keys()
        assert {k: v for k, v in vars(tp).items() if k != "byz"} == \
            {k: v for k, v in vars(jp).items() if k != "byz"}
        assert (tproto.collective_volume_bytes(tp, 815_900_000, fsdp=K)
                == jproto.collective_volume_bytes(jp, 815_900_000, fsdp=K))
    for bad, match in ((dict(gar="median"), "selection-based"),
                       (dict(pull_gar="mda"), "coordinate-wise"),
                       (dict(optimizer="lion"), "unknown optimizer")):
        for mod in (jproto, tproto):
            with pytest.raises(ValueError, match=match):
                mod.ProtocolConfig.derive(5, f_workers=1, f_servers=1, **bad)

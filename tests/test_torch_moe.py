"""The port's MoE family (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` on shared numpy inputs: routing indices with
exact ties, capacity drops, the bf16 combine's summation order at top-3,
forward / loss / grads, prefill + decode, and the quorum service — against
JAX's service and, request by request, against each request's own
single-request run."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, jax_tree, numpy_params
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models.registry import get_bundle as jax_bundle
from repro.serve import QuorumService as JaxQuorumService
from repro.serve import ReplicaPool as JaxReplicaPool
from repro_torch.core.attacks import ByzantineSpec
from repro_torch.models import layers, moe
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_bundle
from repro_torch.serve import QuorumService, ReplicaPool

ARCH = "qwen3-moe-235b-a22b"
# bf16 logits: the dense transformer test's bound (see the test)
TOL_BF16, LOSS_TOL_BF16 = 2e-2, 1e-3


def _cfgs(**over):
    return (jax_bundle(ARCH, reduced=True, **over).cfg,
            get_bundle(ARCH, reduced=True, **over).cfg)


def _tied_router(rng, T, E, D):
    """x one-hot rows and a router on the grid {-1, -1/2, 0, 1/2, 1}: the
    logits are router rows, exact in bf16 and f32 alike and full of ties
    (at the top-k boundary and among whole tokens)."""
    rows = rng.integers(0, D, T)
    x = np.zeros((T, D), np.float32)
    x[np.arange(T), rows] = 1.0
    router = rng.integers(-2, 3, (D, E)).astype(np.float32) / 2
    return x, router


def _jax_routing(logits, K, cap):
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    topw, topi = jax.lax.top_k(probs, K)
    topw = topw / jnp.maximum(jnp.sum(topw, axis=-1, keepdims=True), 1e-9)
    T, E = logits.shape
    wmap = jnp.zeros((T, E), jnp.float32).at[
        jnp.arange(T)[:, None], topi].set(topw)
    wcap, tok_idx = jax.lax.top_k(wmap.T, cap)
    return np.asarray(topi), np.asarray(tok_idx), np.asarray(wcap)


def _exact_tied_logits(rng, T, E, K):
    """Rows with m in {1, 2, 4, 8, 16} maxima at 0 and -inf elsewhere: the
    softmax is 1/m or 0 and the normalized top-k weights 1/K, 1/m or 0,
    exact in both packages, so both top-k picks meet exact ties — among a
    token's experts and among the tokens of an expert."""
    logits = np.full((T, E), -np.inf, np.float32)
    for t in range(T):
        m = rng.choice([m for m in (1, 2, 4, 8, 16) if m <= E])
        logits[t, rng.choice(E, m, replace=False)] = 0.0
    return logits


@pytest.mark.parametrize("T,E,K", [(64, 8, 2), (1024, 128, 8)])
def test_routing_indices_equal_jax_with_exact_ties(T, E, K):
    """The two top-k picks of ``route`` against the reference's routing
    (``jax.lax.top_k``, ``moe.py:76-87``) on the same logits, whose every
    float32 step is exact: equal indices and weights, ties included
    (qwen3-moe's E 128, K 8 at T 1024, and a small case); ``torch.topk``
    orders those ties otherwise."""
    rng = np.random.default_rng(T + E)
    logits = _exact_tied_logits(rng, T, E, K)
    cap = max(int(T * K / E * 1.25), 1)
    topi, tok_idx, wcap = _jax_routing(logits, K, cap)
    got_w, got_idx, got_topi = moe.route(torch.from_numpy(logits), K, cap)
    np.testing.assert_array_equal(got_topi.numpy(), topi)
    np.testing.assert_array_equal(got_idx.numpy(), tok_idx)
    np.testing.assert_array_equal(got_w.numpy(), wcap)
    probs = torch.softmax(torch.from_numpy(logits), -1)
    assert not np.array_equal(torch.topk(probs, K)[1].numpy(), topi)


@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
def test_moe_tokens_with_ties_and_capacity_drops_match_jax(act_dtype):
    """``moe_tokens`` against JAX's ``_moe_tokens`` on tied logits with
    T * K / E * 1.25 < T, so experts drop tokens: the same tokens kept and
    outputs within one rounding of the dtype."""
    jc, tc = _cfgs(act_dtype=act_dtype, n_experts=8, top_k=2)
    T, D = 48, tc.d_model
    rng = np.random.default_rng(3)
    x, router = _tied_router(rng, T, 8, D)
    p_np = {"router": router,
            "w_gate": (0.3 * rng.standard_normal((8, D, tc.d_ff))
                       ).astype(np.float32),
            "w_up": (0.3 * rng.standard_normal((8, D, tc.d_ff))
                     ).astype(np.float32),
            "w_down": (0.1 * rng.standard_normal((8, tc.d_ff, D))
                       ).astype(np.float32)}
    dt = jnp.dtype(act_dtype)
    want = jmoe._moe_tokens(jax_tree(p_np), jnp.asarray(x, dt)[None], jc, dt)
    got = moe.moe_tokens({k: torch.from_numpy(v) for k, v in p_np.items()},
                         torch.from_numpy(x).to(getattr(torch, act_dtype)),
                         tc, getattr(torch, act_dtype))
    cap = moe.capacity(T, tc)
    assert cap == int(T * 2 / 8 * 1.25) < T
    wcap, _, _ = moe.route(torch.from_numpy(x @ router), 2, cap)
    assert int((wcap > 0).sum()) < T * 2          # tokens were dropped
    tol = 1e-5 if act_dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want[0], np.float32), rtol=tol,
                               atol=tol)


def test_bf16_combine_adds_in_jax_scatter_order():
    """top_k = 3 in bf16: each token's three expert outputs added in the
    order XLA's scatter-add applies them (expert-ascending) — bit-equal to
    the reference's combine on the same routing and outputs, on values
    whose bf16 sum depends on that order."""
    T, E, K, D = 256, 8, 3, 64
    rng = np.random.default_rng(5)
    cfg = _cfgs(n_experts=E, top_k=K)[1]
    cap = moe.capacity(T, cfg)
    logits = rng.standard_normal((T, E)).astype(np.float32)
    wcap, tok_idx, topi = moe.route(torch.from_numpy(logits), K, cap)
    keep = wcap > 0
    # magnitudes 1, 2^-9 and 2^-9: in bf16, (1 + a) + b != 1 + (a + b)
    mag = rng.choice([1.0, 2.0 ** -9], size=(E, cap, 1))
    out = (mag * rng.choice([1.0, 1.0078125], (E, cap, D))).astype(np.float32)
    out_j = jnp.asarray(out, jnp.bfloat16)
    flat_idx = jnp.where(jnp.asarray(keep.numpy()), jnp.asarray(
        tok_idx.numpy()), T).reshape(-1)
    want = jnp.zeros((T + 1, D), jnp.bfloat16).at[flat_idx].add(
        out_j.reshape(E * cap, D))[:T]
    pos = moe.slots(tok_idx, keep, topi)
    rows = torch.from_numpy(out).bfloat16().reshape(E * cap, D)
    got = moe.sum_slots(rows, pos)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    # the order matters on these values: descending experts differ
    rev = moe.sum_slots(rows, pos.flip(-1))
    assert not torch.equal(rev, got)


@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
def test_forward_loss_and_grads_match_jax(act_dtype):
    """The reduced qwen3-moe (4 experts, top-2, 2 layers): forward
    logits, loss and every leaf's gradient against ``jax.grad`` on the same
    numpy params and tokens. float32: rtol 1e-4 (the same routing, sums in
    other orders). bf16: both round the activations at every matmul, in
    other orders (seen: 5.6e-3 on logits of scale 1.0), held to the dense
    transformer test's 2e-2; the loss within 1e-3."""
    jb = jax_bundle(ARCH, reduced=True, act_dtype=act_dtype)
    tb = get_bundle(ARCH, reduced=True, act_dtype=act_dtype)
    p_np = numpy_params(jb.cfg, seed=11)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, jb.cfg.vocab, (2, 33)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(toks[:, 1:])}
    tbatch = {k: torch.from_numpy(np.array(v)).long()
              for k, v in jbatch.items()}
    jp = jax_tree(p_np)
    jh = jlayers.unembed(jp["embed"], jmoe.forward(jp, jbatch["tokens"],
                                                   cfg=jb.cfg))
    tp = params_from_jax(p_np, tb.cfg, device=CPU)
    th = layers.unembed(tp["embed"], moe.forward(tp, tbatch["tokens"],
                                                 cfg=tb.cfg))
    if act_dtype != "float32":
        np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                                   rtol=TOL_BF16, atol=TOL_BF16)
        assert abs(float(tb.loss(tp, tbatch)) - float(jb.loss(jp, jbatch))
                   ) < LOSS_TOL_BF16
        return
    jl, jg = jax.value_and_grad(jb.loss)(jp, jbatch)
    leaves = {}

    def track(t, path=""):
        if isinstance(t, dict):
            return {k: track(v, f"{path}/{k}") for k, v in t.items()}
        leaves[path] = t.requires_grad_()
        return t

    tl = tb.loss(track(tp), tbatch)
    tl.backward()
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                               rtol=1e-4, atol=1e-4)
    assert abs(float(tl) - float(jl)) < 1e-5
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    for path, g in flat:
        key = "".join(f"/{p.key}" for p in path)
        want = np.asarray(g)
        np.testing.assert_allclose(
            leaves[key].grad.numpy(), want, rtol=1e-4,
            atol=1e-4 * np.abs(want).max(), err_msg=key)


@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(act_dtype):
    """A batch of 2 prompts of 20 tokens routed together, then 3 decode
    steps (2 tokens routed together each): last-token logits against JAX's
    ``prefill`` / ``decode_step`` on the same params."""
    over = dict(act_dtype=act_dtype, q_block=8, kv_block=8)
    jb = jax_bundle(ARCH, reduced=True, **over)
    tb = get_bundle(ARCH, reduced=True, **over)
    p_np = numpy_params(jb.cfg, seed=21)
    jp, tp = jax_tree(p_np), params_from_jax(p_np, tb.cfg, device=CPU)
    rng = np.random.default_rng(22)
    toks = rng.integers(0, jb.cfg.vocab, (2, 20)).astype(np.int32)
    steps = rng.integers(0, jb.cfg.vocab, (3, 2, 1)).astype(np.int32)
    jc = jb.init_caches(2, max_len=24, n_chunks=4)
    tc = tb.init_caches(2, max_len=24, n_chunks=4, device=CPU)
    jl, jc = jax.jit(jb.prefill)(jp, {"tokens": jnp.asarray(toks)}, jc)
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[act_dtype]
    with torch.inference_mode():
        tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                                   atol=tol)
        jdec = jax.jit(jb.decode)
        for t in steps:
            jl, jc = jdec(jp, jc, {"token": jnp.asarray(t)})
            tl, tc = tb.decode(tp, tc, {"token": torch.from_numpy(t).long()})
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                                       atol=tol)


def test_decode_replicas_routes_each_row_alone():
    """The serving decode routes each row on its own: a batch of two rows
    gives each row's logits bit for bit as a B = 1 decode, while the
    launch driver's ``decode`` routes the rows together — every token picks
    all 4 experts, each expert keeps one token of the two, so a row loses
    experts to the other and its logits differ."""
    tb = get_bundle(ARCH, reduced=True, act_dtype="float32", n_experts=4,
                    top_k=4, capacity_factor=0.5)
    p = params_from_jax(numpy_params(tb.cfg, 31), tb.cfg, device=CPU)
    prompts = [[5, 9, 2, 7, 1], [3, 8, 8]]

    def filled():
        c = tb.init_caches(2, max_len=16, n_chunks=4, device=CPU)
        for r, pr in enumerate(prompts):
            tb.prefill(p, {"tokens": torch.tensor([pr])},
                       tb.cache_rows(c, slice(r, r + 1)))
        return c

    tok = torch.tensor([[4], [6]])
    with torch.inference_mode():
        alone = []
        for r, pr in enumerate(prompts):
            c = tb.init_caches(1, max_len=16, n_chunks=4, device=CPU)
            tb.prefill(p, {"tokens": torch.tensor([pr])}, c)
            alone.append(tb.decode(p, c, {"token": tok[r:r + 1]})[0][0])
        both = tb.decode_replicas([p], [filled()], tok)[0]
        together = tb.decode(p, filled(), {"token": tok})[0]
    assert torch.equal(both, torch.stack(alone))
    assert not torch.allclose(together, both, atol=1e-3)


def _svc(pool, bundle, n_slots=2, **kw):
    return QuorumService(pool, bundle, n_slots=n_slots, max_len=32, **kw)


def test_service_matches_jax_and_each_request_its_own_run():
    """The quorum service on the reduced qwen3-moe (f32 activations, 4
    replicas, the last reversed, f = 1, 2 slots, 3 requests so one slot
    refills): the same tokens and ejections as the JAX service, and every
    request equal to its own B = 1 prefill + decode run."""
    over = dict(act_dtype="float32")
    jb = jax_bundle(ARCH, reduced=True, **over)
    tb = get_bundle(ARCH, reduced=True, **over)
    p_np = numpy_params(jb.cfg, seed=41)
    rng = np.random.default_rng(42)
    # the refill's prompt has the first one's length: one JAX compile less
    prompts = [rng.integers(0, jb.cfg.vocab, n).tolist() for n in (5, 11, 5)]
    from repro.core.attacks import ByzantineSpec as JaxSpec
    spec = dict(server_attack="reversed", n_byz_servers=1)
    jpool = JaxReplicaPool.from_params(jax_tree(p_np), 4, f=1).corrupt(
        JaxSpec(**spec), jax.random.PRNGKey(0))
    jsvc = JaxQuorumService(jpool, jb, n_slots=2, max_len=32)
    jout = jsvc.generate(prompts, max_new=6)

    tp = params_from_jax(p_np, tb.cfg, device=CPU)
    svc = _svc(ReplicaPool.from_params(tp, 4, f=1).corrupt(
        ByzantineSpec(**spec)), tb)
    with torch.inference_mode():
        tout = svc.generate(prompts, max_new=6)
        single = []
        for pr in prompts:
            c = tb.init_caches(1, max_len=32, n_chunks=4, device=CPU)
            lg, c = tb.prefill(tp, {"tokens": torch.tensor([pr])}, c)
            out = [int(lg.argmax(-1))]
            for _ in range(5):
                lg, c = tb.decode(tp, c, {"token": torch.tensor([out[-1:]])})
                out.append(int(lg.argmax(-1)))
            single.append(out)
    assert tout == jout
    assert tout == single
    assert svc.report()["refills"] >= 1
    assert ([i for _, i in svc.report()["ejections"]]
            == [i for _, i in jsvc.report()["ejections"]] == [3])


def test_bundle_builds_every_ported_moe_arch():
    """``get_bundle`` builds qwen3-moe and dbrx at full config (no params)
    and their reduced siblings run a loss."""
    for arch in ("qwen3-moe-235b-a22b", "dbrx-132b"):
        assert get_bundle(arch).cfg.family == "moe"
        tb = get_bundle(arch, reduced=True)
        p = tb.init(torch.Generator().manual_seed(0))
        batch = tb.make_batch("train", 2, 16, torch.Generator().manual_seed(1))
        assert torch.isfinite(tb.loss(p, batch))

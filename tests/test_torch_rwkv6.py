"""The port's RWKV6 family (``repro_torch.models.rwkv6``) against the JAX
package's ``repro.models.rwkv6`` on shared numpy inputs, with a non-zero
decay LoRA ``wB`` (zero at init, where ``wA`` would get no gradient): the
chunked WKV scan at a length that pads, the single-step decode branch
against the scan, forward / loss / grads, prefill + decode, and the quorum
service — whose every request equals its own fresh single-request run (the
port resets a slot's state at each prefill; the JAX service does not), and
whose first fill of each slot equals the JAX service's tokens."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, jax_tree, numpy_params
from repro.models import layers as jlayers
from repro.models import rwkv6 as jrwkv
from repro.models.registry import get_bundle as jax_bundle
from repro.serve import QuorumService as JaxQuorumService
from repro.serve import ReplicaPool as JaxReplicaPool
from repro_torch.core.attacks import ByzantineSpec
from repro_torch.models import layers, rwkv6
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_bundle
from repro_torch.serve import QuorumService, ReplicaPool

ARCH = "rwkv6-3b"
# bf16 logits (see the test)
TOL_BF16, LOSS_TOL_BF16 = 5e-2, 2e-3


def _scan_inputs(rng, B, S, H, K):
    def a(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    lw = -np.exp(a(B, S, H, K, scale=0.5)).astype(np.float32)
    return (a(B, S, H, K), a(B, S, H, K), a(B, S, H, K), lw,
            a(H, K, scale=0.1), a(B, H, K, K, scale=0.3))


def test_wkv_chunked_pads_and_matches_jax():
    """S = 37 (three chunks of 16, the last padded), from a non-zero
    state: y and the final state against JAX's ``wkv_chunked`` in f32 (sums
    in other orders; seen 1.3e-5 on y of scale 4)."""
    args = _scan_inputs(np.random.default_rng(0), 2, 37, 3, 8)
    jy, js = jrwkv.wkv_chunked(*(jnp.asarray(x) for x in args))
    ty, ts = rwkv6.wkv_chunked(*(torch.from_numpy(x) for x in args))
    assert ty.shape == (2, 37, 3, 8) and ts.shape == (2, 3, 8, 8)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=5e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)


def test_wkv_chunked_grads_match_jax_vjp():
    """The same scan's gradients of r, k, v, lw, u and s0 for random
    cotangents of y and the final state, against ``jax.vjp`` of JAX's
    ``wkv_chunked`` in f32 (the chunk recurrence's backward is the port's
    ``state_scan``; sums in other orders: seen 1.0e-6 to 3.2e-5 of each
    gradient's largest entry, varying between processes in r, k, v and lw,
    whose products the CPU's BLAS sums in another order from process to
    process; u's and s0's at 1.7e-7 and 7.3e-8 every time)."""
    rng = np.random.default_rng(3)
    args = _scan_inputs(rng, 2, 37, 3, 8)
    cot_y = rng.standard_normal((2, 37, 3, 8)).astype(np.float32)
    cot_s = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    _, vjp = jax.vjp(jrwkv.wkv_chunked, *(jnp.asarray(x) for x in args))
    want = vjp((jnp.asarray(cot_y), jnp.asarray(cot_s)))
    ts = [torch.from_numpy(x).requires_grad_() for x in args]
    ty, tfin = rwkv6.wkv_chunked(*ts)
    got = torch.autograd.grad(
        (ty * torch.from_numpy(cot_y)).sum()
        + (tfin * torch.from_numpy(cot_s)).sum(), ts)
    for name, g, w in zip(("r", "k", "v", "lw", "u", "s0"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_decode_branch_equals_the_chunked_scan():
    """``time_mix`` over 21 tokens in one call (the chunked scan) and one
    token at a time with a cache (the exact single-step branch): the same
    outputs and final state; and the single step against JAX's."""
    cfg = get_bundle(ARCH, reduced=True, act_dtype="float32").cfg
    jcfg = jax_bundle(ARCH, reduced=True, act_dtype="float32").cfg
    p_np = {k: v[0] for k, v in numpy_params(cfg, 1)["blocks"].items()
            if not isinstance(v, dict)}
    p_np["ln_x"] = {k: v[0] for k, v in
                    numpy_params(cfg, 1)["blocks"]["ln_x"].items()}
    tp = {k: ({a: torch.from_numpy(b) for a, b in v.items()}
              if isinstance(v, dict) else torch.from_numpy(v))
          for k, v in p_np.items()}
    rng = np.random.default_rng(2)
    S, D = 21, cfg.d_model
    x = torch.from_numpy(rng.standard_normal((2, S, D)).astype(np.float32))
    zero = rwkv6.init_caches(cfg, 2)
    c0 = rwkv6.RwkvCache(*(t[0] for t in zero))
    whole, _, s_whole = rwkv6.time_mix(tp, x, cfg, torch.float32, c0)
    c = c0
    steps = []
    for t in range(S):
        out, shift, s = rwkv6.time_mix(tp, x[:, t:t + 1], cfg, torch.float32,
                                       c)
        steps.append(out)
        c = rwkv6.RwkvCache(shift, c.shift_c, s)
    torch.testing.assert_close(torch.cat(steps, 1), whole, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(s, s_whole, rtol=1e-4, atol=1e-4)
    jc = jrwkv.RwkvCache(jnp.asarray(c.shift_t.numpy()),
                         jnp.asarray(c.shift_c.numpy()),
                         jnp.asarray(c.wkv.numpy()))
    xn = rng.standard_normal((2, 1, D)).astype(np.float32)
    jout, _, js = jrwkv.time_mix(jax_tree(p_np), jnp.asarray(xn), jcfg,
                                 jnp.float32, jc)
    tout, _, ts = rwkv6.time_mix(tp, torch.from_numpy(xn), cfg,
                                 torch.float32, c)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
def test_forward_loss_and_grads_match_jax(act_dtype):
    """The reduced rwkv6 (d_model 128, 2 heads of 64, 2 layers, S = 40:
    three chunks, the last padded) with a non-zero ``wB``: forward logits,
    loss and every leaf's gradient (``wA`` included) against ``jax.grad``.
    float32: rtol 1e-4. bf16: r, k, v and the gate round to bf16 before
    the float32 scan, in other orders (seen: 2.5e-2 on logits of scale
    1.1), held to 5e-2; the loss within 2e-3."""
    jb = jax_bundle(ARCH, reduced=True, act_dtype=act_dtype)
    tb = get_bundle(ARCH, reduced=True, act_dtype=act_dtype)
    p_np = numpy_params(jb.cfg, seed=11)
    assert np.abs(p_np["blocks"]["wB"]).max() > 0
    rng = np.random.default_rng(12)
    toks = rng.integers(0, jb.cfg.vocab, (2, 41)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(toks[:, 1:])}
    tbatch = {k: torch.from_numpy(np.array(v)).long()
              for k, v in jbatch.items()}
    jp = jax_tree(p_np)
    jh = jlayers.unembed(jp["embed"], jrwkv.forward(jp, jbatch["tokens"],
                                                    cfg=jb.cfg))
    tp = params_from_jax(p_np, tb.cfg, device=CPU)
    th = layers.unembed(tp["embed"], rwkv6.forward(tp, tbatch["tokens"],
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
    assert np.abs(np.asarray(jg["blocks"]["wA"])).max() > 0
    for path, g in flat:
        key = "".join(f"/{p.key}" for p in path)
        want = np.asarray(g)
        np.testing.assert_allclose(
            leaves[key].grad.numpy(), want, rtol=1e-4,
            atol=1e-4 * np.abs(want).max(), err_msg=key)


def test_decay_floor_splits_a_tie_gradient_as_jax():
    """The floor of ``lw = maximum(-exp(wlog), -20)`` at an exact tie: the
    gradient is halved, as ``jnp.maximum``'s (``clamp`` would pass it
    whole)."""
    floor = rwkv6.LOG_DECAY_FLOOR
    jg = jax.grad(lambda a: jnp.sum(jnp.maximum(a, floor)))(
        jnp.asarray([floor, -3.0], jnp.float32))
    t = torch.tensor([floor, -3.0], requires_grad=True)
    torch.maximum(t, t.new_tensor(floor)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jg))
    assert t.grad.tolist() == [0.5, 1.0]


@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(act_dtype):
    """Prompts of 37 tokens (the scan pads) and of 1 token (the decode
    branch, from the zero state), then 3 decode steps: logits against JAX's
    ``prefill`` / ``decode_step`` on the same params."""
    jb = jax_bundle(ARCH, reduced=True, act_dtype=act_dtype)
    tb = get_bundle(ARCH, reduced=True, act_dtype=act_dtype)
    p_np = numpy_params(jb.cfg, seed=21)
    jp, tp = jax_tree(p_np), params_from_jax(p_np, tb.cfg, device=CPU)
    rng = np.random.default_rng(22)
    tol = {"float32": 1e-4, "bfloat16": 5e-2}[act_dtype]
    jdec = jax.jit(jb.decode)
    for S in (37, 1):
        toks = rng.integers(0, jb.cfg.vocab, (2, S)).astype(np.int32)
        steps = rng.integers(0, jb.cfg.vocab, (3, 2, 1)).astype(np.int32)
        jc = jb.init_caches(2, max_len=64, n_chunks=1)
        tc = tb.init_caches(2, max_len=64, n_chunks=1, device=CPU)
        jl, jc = jax.jit(jb.prefill)(jp, {"tokens": jnp.asarray(toks)}, jc)
        with torch.inference_mode():
            tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                                tc)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                                       atol=tol)
            for t in steps:
                jl, jc = jdec(jp, jc, {"token": jnp.asarray(t)})
                tl, tc = tb.decode(tp, tc,
                                   {"token": torch.from_numpy(t).long()})
                np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                           rtol=tol, atol=tol)
        np.testing.assert_allclose(tc.wkv.numpy(), np.asarray(jc.wkv),
                                   rtol=tol, atol=tol)


def _fresh_run(tb, params, prompt, max_new):
    c = tb.init_caches(1, max_len=0, device=CPU)
    lg, c = tb.prefill(params, {"tokens": torch.tensor([prompt])}, c)
    out = [int(lg.argmax(-1))]
    for _ in range(max_new - 1):
        lg, c = tb.decode(params, c, {"token": torch.tensor([out[-1:]])})
        out.append(int(lg.argmax(-1)))
    return out


def test_prefill_starts_from_the_state_it_is_given():
    """Why the service resets a slot: a prefill into a state another
    request left gives other logits than from the zero state."""
    tb = get_bundle(ARCH, reduced=True, act_dtype="float32")
    tp = params_from_jax(numpy_params(tb.cfg, 31), tb.cfg, device=CPU)
    with torch.inference_mode():
        used = tb.init_caches(1, 0, device=CPU)
        tb.prefill(tp, {"tokens": torch.tensor([[7, 3, 9]])}, used)
        dirty, _ = tb.prefill(tp, {"tokens": torch.tensor([[5, 1]])}, used)
        clean, _ = tb.prefill(tp, {"tokens": torch.tensor([[5, 1]])},
                              tb.reset_cache_rows(used, slice(0, 1)))
        fresh, _ = tb.prefill(tp, {"tokens": torch.tensor([[5, 1]])},
                              tb.init_caches(1, 0, device=CPU))
    assert not torch.allclose(dirty, clean, atol=1e-3)
    assert torch.equal(clean, fresh)


def test_service_requests_equal_fresh_runs_and_first_fills_equal_jax():
    """The quorum service on the reduced rwkv6 (f32 activations, 4
    replicas, the last reversed, f = 1, 2 slots, 5 requests, so both slots
    refill): every request equals its own fresh single-request run (the
    slot's state reset at each prefill), and the requests of each slot's
    first fill equal the JAX service's tokens (a refilled JAX slot starts
    from its last request's state: ROADMAP Queue 3)."""
    over = dict(act_dtype="float32")
    jb = jax_bundle(ARCH, reduced=True, **over)
    tb = get_bundle(ARCH, reduced=True, **over)
    p_np = numpy_params(jb.cfg, seed=41)
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, jb.cfg.vocab, n).tolist()
               for n in (5, 18, 7, 1, 9)]
    spec = dict(server_attack="reversed", n_byz_servers=1)
    tp = params_from_jax(p_np, tb.cfg, device=CPU)
    svc = QuorumService(ReplicaPool.from_params(tp, 4, f=1).corrupt(
        ByzantineSpec(**spec)), tb, n_slots=2, max_len=32)
    with torch.inference_mode():
        tout = svc.generate(prompts, max_new=6)
        fresh = [_fresh_run(tb, tp, pr, 6) for pr in prompts]
    assert tout == fresh
    assert svc.report()["refills"] >= 3
    assert [i for _, i in svc.report()["ejections"]] == [3]

    from repro.core.attacks import ByzantineSpec as JaxSpec
    jpool = JaxReplicaPool.from_params(jax_tree(p_np), 4, f=1).corrupt(
        JaxSpec(**spec), jax.random.PRNGKey(0))
    jsvc = JaxQuorumService(jpool, jb, n_slots=2, max_len=32)
    jout = jsvc.generate(prompts[:2], max_new=6)
    assert tout[:2] == jout


def test_bundle_builds_rwkv6_3b():
    """``get_bundle("rwkv6-3b")`` at full config (no params); its reduced
    sibling's init matches the JAX tree and runs a loss."""
    assert get_bundle(ARCH).cfg.family == "ssm"
    jb, tb = jax_bundle(ARCH, reduced=True), get_bundle(ARCH, reduced=True)
    want = jax.tree.map(lambda l: tuple(l.shape),
                        jax.eval_shape(jb.init, jax.random.PRNGKey(0)))
    got = tb.init(torch.Generator().manual_seed(0))

    def shapes(t):
        return ({k: shapes(v) for k, v in t.items()} if isinstance(t, dict)
                else tuple(t.shape))
    assert shapes(got) == want
    batch = tb.make_batch("train", 2, 16, torch.Generator().manual_seed(1))
    assert torch.isfinite(tb.loss(got, batch))

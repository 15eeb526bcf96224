"""The port's hybrid family (``repro_torch.models.hybrid``, zamba2-1.2b)
against the JAX package's ``repro.models.hybrid`` on shared numpy params:
reduced to 7 Mamba2 layers with the shared block after every 2 (three
sites and a remainder of one layer), float32 activations. The loss and
every leaf's gradient (the shared block's summed over its three sites)
against ``jax.grad``; prefill and decode against JAX's; and the quorum
service, whose every request equals its own fresh single-request run (the
port resets a slot's Mamba2 state at each prefill; the JAX service does
not) and whose first fill of each slot equals the JAX service's tokens.
Whole models and gradients: rtol 1e-4, atol 1e-4 (gradients: scaled by
the largest). The launchers run it to the end on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import CPU, jax_tree, numpy_params
from repro.models.registry import get_bundle as jax_bundle
from repro.serve import QuorumService as JaxQuorumService
from repro.serve import ReplicaPool as JaxReplicaPool
from repro_torch.core.attacks import ByzantineSpec
from repro_torch.models import hybrid
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_bundle
from repro_torch.serve import QuorumService, ReplicaPool

ARCH = "zamba2-1.2b"
OVER = dict(act_dtype="float32")


def _bundles(**over):
    over = dict(OVER, **over)
    return jax_bundle(ARCH, reduced=True, **over), \
        get_bundle(ARCH, reduced=True, **over)


def test_reduced_config_has_three_sites_and_a_remainder():
    tb = get_bundle(ARCH, reduced=True)
    assert (tb.cfg.n_layers, tb.cfg.shared_attn_every) == (7, 2)
    assert hybrid.n_shared_sites(tb.cfg) == 3
    assert [(list(r), s) for r, s in hybrid._segments(tb.cfg)] == [
        ([0, 1], 0), ([2, 3], 1), ([4, 5], 2), ([6], None)]


def test_loss_and_grads_match_jax():
    """S = 70 (the SSD scan's second chunk padded): the loss and every
    leaf's gradient, the shared block's (used at three sites) included."""
    jb, tb = _bundles()
    p_np = numpy_params(jb.cfg, seed=3)
    toks = np.random.default_rng(4).integers(
        0, jb.cfg.vocab, (2, 71)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(toks[:, 1:])}
    jl, jg = jax.jit(jax.value_and_grad(jb.loss))(jax_tree(p_np), jbatch)
    leaves = {}

    def track(t, path=""):
        if isinstance(t, dict):
            return {k: track(v, f"{path}/{k}") for k, v in t.items()}
        leaves[path] = t.requires_grad_()
        return t

    tl = tb.loss(track(params_from_jax(p_np, tb.cfg, device=CPU)),
                 {k: torch.from_numpy(np.array(v)).long()
                  for k, v in jbatch.items()})
    tl.backward()
    assert abs(tl.item() - float(jl)) < 1e-5
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert {"/shared/attn/wq", "/mamba/A_log", "/mamba/conv_w"} <= set(leaves)
    for path, g in flat:
        key = "".join(f"/{p.key}" for p in path)
        want = np.asarray(g)
        assert np.abs(want).max() > 0, key
        np.testing.assert_allclose(leaves[key].grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=key)


def test_prefill_and_decode_match_jax():
    """Prompts of 37 tokens (the scan, one chunk padded) and of 1 token
    (the single-step branch), then 3 decode steps from the caches: logits
    against JAX's, and the final SSM states and KV lengths (per row in the
    port, one per site in JAX)."""
    jb, tb = _bundles()
    p_np = numpy_params(jb.cfg, seed=21)
    jp, tp = jax_tree(p_np), params_from_jax(p_np, tb.cfg, device=CPU)
    rng = np.random.default_rng(22)
    jpre, jdec = jax.jit(jb.prefill), jax.jit(jb.decode)
    for S in (37, 1):
        toks = rng.integers(0, jb.cfg.vocab, (2, S)).astype(np.int32)
        steps = rng.integers(0, jb.cfg.vocab, (3, 2, 1)).astype(np.int32)
        # float32 caches (conv window and KV): a bf16 cache rounds values
        # that differ in the last float32 bits, and a few round apart
        jc = jb.init_caches(2, max_len=64, n_chunks=4, dtype=jnp.float32)
        tc = tb.init_caches(2, max_len=64, n_chunks=4, dtype=torch.float32,
                            device=CPU)
        jl, jc = jpre(jp, {"tokens": jnp.asarray(toks)}, jc)
        with torch.inference_mode():
            tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                                tc)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                       atol=1e-4)
            for t in steps:
                jl, jc = jdec(jp, jc, {"token": jnp.asarray(t)})
                tl, tc = tb.decode(tp, tc,
                                   {"token": torch.from_numpy(t).long()})
                np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                           rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tc.mamba.ssm.numpy(),
                                   np.asarray(jc.mamba.ssm), rtol=1e-4,
                                   atol=1e-4)
        assert tc.attn.length.tolist() == [[S + 3] * 2] * 3
        assert np.asarray(jc.attn.length).tolist() == [S + 3] * 3


def _fresh_run(tb, params, prompt, max_new):
    c = tb.init_caches(1, max_len=32, n_chunks=4, device=CPU)
    lg, c = tb.prefill(params, {"tokens": torch.tensor([prompt])}, c)
    out = [int(lg.argmax(-1))]
    for _ in range(max_new - 1):
        lg, c = tb.decode(params, c, {"token": torch.tensor([out[-1:]])})
        out.append(int(lg.argmax(-1)))
    return out


def test_prefill_starts_from_the_state_it_is_given():
    """Why the service resets a slot: a prefill into the Mamba2 state
    another request left gives other logits than from the zero state."""
    tb = get_bundle(ARCH, reduced=True, **OVER)
    tp = params_from_jax(numpy_params(tb.cfg, 31), tb.cfg, device=CPU)
    with torch.inference_mode():
        used = tb.init_caches(1, 16, 4, device=CPU)
        tb.prefill(tp, {"tokens": torch.tensor([[7, 3, 9]])}, used)
        dirty, _ = tb.prefill(tp, {"tokens": torch.tensor([[5, 1]])}, used)
        clean, _ = tb.prefill(tp, {"tokens": torch.tensor([[5, 1]])},
                              tb.reset_cache_rows(used, slice(0, 1)))
        fresh, _ = tb.prefill(tp, {"tokens": torch.tensor([[5, 1]])},
                              tb.init_caches(1, 16, 4, device=CPU))
    assert not torch.allclose(dirty, clean, atol=1e-3)
    assert torch.equal(clean, fresh)


def test_service_requests_equal_fresh_runs_and_first_fills_equal_jax():
    """The quorum service (4 replicas, the last reversed, f = 1, 2 slots,
    5 requests, so both slots refill): every request equals its own fresh
    single-request run, the reversed replica is ejected, and the requests
    of each slot's first fill equal the JAX service's tokens (a refilled
    JAX slot starts from its last request's state: ROADMAP Queue 3)."""
    jb, tb = _bundles()
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
    assert tout[:2] == jsvc.generate(prompts[:2], max_new=6)


def test_bundle_init_matches_the_jax_tree():
    """The reduced sibling's init has the JAX tree's leaves and shapes and
    runs a finite loss."""
    jb, tb = _bundles()
    want = jax.tree.map(lambda l: tuple(l.shape),
                        jax.eval_shape(jb.init, jax.random.PRNGKey(0)))
    got = tb.init(torch.Generator().manual_seed(0))

    def shapes(t):
        return ({k: shapes(v) for k, v in t.items()} if isinstance(t, dict)
                else tuple(t.shape))
    assert shapes(got) == want
    batch = tb.make_batch("train", 2, 16, torch.Generator().manual_seed(1))
    assert torch.isfinite(tb.loss(got, batch))


def test_launchers_run_zamba2_on_the_cpu():
    """``launch/train.py --arch zamba2-1.2b --reduced --device cpu``: 2
    protocol steps at G = 4 (T = 2: a gather) on the token stream, finite
    losses; ``launch/serve.py``: a prefill of 16 and 4 decode steps."""
    from repro_torch.launch import serve, train
    run = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--steps", "2", "--groups", "4", "--seq", "16",
                      "--batch-per-group", "2", "--T", "2",
                      "--log-every", "1"])
    assert run.state.t == 2 and len(run.losses) == 2
    assert np.all(np.isfinite([loss for _, loss in run.losses]))
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prefill", "16", "--decode", "4"])
    assert out.shape == (2, 5) and int(out.max()) < run.bundle.cfg.vocab

"""The port's vlm family (qwen2-vl-7b: the dense transformer fed merged
``embeds`` and ``[3, B, S]`` M-RoPE position ids) against the JAX package
on shared numpy params and inputs: M-RoPE against JAX's ``apply_rope``,
and equal to standard RoPE when the three ids are equal; the reduced
qwen2-vl (2 layers, 4 query heads of 32 over 2 kv heads, so M-RoPE's
sections are 8/4/4 of the 16 frequencies; float32 activations): loss and
gradients, and prefill plus 3 decode steps fed embeds and positions as the
serving launcher feeds them. Single functions: rtol / atol 1e-5 (bf16:
one bf16 step at the largest magnitude); whole models and gradients 1e-4
(gradients: atol scaled by the largest). The launchers run it to the end
on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, jax_tree, np_dtype_cast, numpy_params
from repro.models import layers as jlayers
from repro.models.registry import get_bundle as jax_bundle
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_bundle

ARCH = "qwen2-vl-7b"
OVER = dict(act_dtype="float32")


def test_mrope_sections_default_as_the_reference():
    assert layers.mrope_sections(64) == (32, 16, 16)      # hd 128
    assert layers.mrope_sections(16) == (8, 4, 4)         # the reduced hd 32
    assert layers.mrope_sections(5) == (3, 1, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mrope_matches_jax_apply_rope(dtype):
    """[3, B, S] ids whose components differ (temporal, height, width of
    image patches), theta 1e6, hd 128."""
    rng = np.random.default_rng(0)
    B, S, H, hd = 2, 13, 3, 128
    jx, tx = np_dtype_cast(rng.standard_normal((B, S, H, hd)), dtype)
    pos = rng.integers(0, 4096, (3, B, S)).astype(np.int32)
    want = np.asarray(jlayers.apply_rope(jx, jnp.asarray(pos), 1e6)
                      .astype(jnp.float32))
    got = layers.apply_rope(tx, torch.from_numpy(pos).long(), 1e6)
    assert got.dtype == tx.dtype
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=step)
    # the three components really differ: the first section alone is not it
    flat = layers.apply_rope(tx, torch.from_numpy(pos[0]).long(), 1e6)
    assert not np.allclose(flat.float().numpy(), want, atol=1e-2)


def test_mrope_matches_rope_for_equal_ids():
    """Text-only M-RoPE (all three components equal) == standard RoPE."""
    B, S, H, hd = 2, 11, 3, 16
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (B, S, H, hd)).astype(np.float32))
    pos = torch.arange(S)[None].expand(B, S)
    a = layers.apply_rope(x, pos, 1e4)
    b = layers.apply_rope(x, pos[None].expand(3, B, S), 1e4)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def _inputs(rng, cfg, B, S):
    return {"embeds": (0.5 * rng.standard_normal((B, S, cfg.d_model))
                       ).astype(np.float32),
            "positions": rng.integers(0, S, (3, B, S)).astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) if v.dtype == np.float32
            else torch.from_numpy(v).long() for k, v in batch.items()}


def test_loss_and_grads_match_jax():
    jb, tb = (jax_bundle(ARCH, reduced=True, **OVER),
              get_bundle(ARCH, reduced=True, **OVER))
    assert (tb.cfg.n_heads, tb.cfg.n_kv_heads, tb.cfg.hd) == (4, 2, 32)
    p_np = numpy_params(jb.cfg, seed=2)
    rng = np.random.default_rng(3)
    batch = dict(_inputs(rng, jb.cfg, 2, 40),
                 labels=rng.integers(0, jb.cfg.vocab, (2, 40)).astype(
                     np.int32))
    jl, jg = jax.jit(jax.value_and_grad(jb.loss))(
        jax_tree(p_np), {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = {}

    def track(t, path=""):
        if isinstance(t, dict):
            return {k: track(v, f"{path}/{k}") for k, v in t.items()}
        leaves[path] = t.requires_grad_()
        return t

    tl = tb.loss(track(params_from_jax(p_np, tb.cfg, device=CPU)),
                 _torch_batch(batch))
    tl.backward()
    assert abs(tl.item() - float(jl)) < 1e-5
    for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]:
        key = "".join(f"/{p.key}" for p in path)
        want = np.asarray(g)
        np.testing.assert_allclose(leaves[key].grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=key)


def test_prefill_and_decode_match_jax():
    """Prefill of 20 merged embeddings at [3, B, S] ids, then 3 decode
    steps fed the last embedding at the last ids + i + 1 (the serving
    launcher's feed, ``repro/launch/serve.py:123-125``): logits against
    JAX's, float32 caches on both sides."""
    jb, tb = (jax_bundle(ARCH, reduced=True, **OVER),
              get_bundle(ARCH, reduced=True, **OVER))
    p_np = numpy_params(jb.cfg, seed=4)
    jp, tp = jax_tree(p_np), params_from_jax(p_np, tb.cfg, device=CPU)
    pf = _inputs(np.random.default_rng(5), jb.cfg, 2, 20)
    jc = jb.init_caches(2, max_len=32, n_chunks=4, dtype=jnp.float32)
    tc = tb.init_caches(2, max_len=32, n_chunks=4, dtype=torch.float32,
                        device=CPU)
    jl, jc = jax.jit(jb.prefill)(jp, {k: jnp.asarray(v)
                                      for k, v in pf.items()}, jc)
    jdec = jax.jit(jb.decode)
    tpf = _torch_batch(pf)
    with torch.inference_mode():
        tl, tc = tb.prefill(tp, tpf, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        for i in range(3):
            jl, jc = jdec(jp, jc, {
                "embeds": jnp.asarray(pf["embeds"][:, -1:]),
                "positions": jnp.asarray(pf["positions"][:, :, -1:] + i + 1)})
            tl, tc = tb.decode(tp, tc, serve.decode_batch(tb, tpf, None, i))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                       atol=1e-4)
    assert tc.length.tolist() == [[23, 23]] * 2


def test_make_batch_has_the_references_shapes():
    tb = get_bundle(ARCH, reduced=True)
    g = torch.Generator().manual_seed(0)
    pf = tb.make_batch("prefill", 2, 16, g)
    assert pf["embeds"].shape == (2, 16, 128)
    assert pf["embeds"].dtype == torch.bfloat16
    assert pf["positions"].shape == (3, 2, 16)
    assert 0 <= int(pf["positions"].min()) and int(pf["positions"].max()) < 16
    assert pf["labels"].shape == (2, 16)
    dec = tb.make_batch("decode", 2, 16, g)
    assert dec["embeds"].shape == (2, 1, 128)
    assert dec["positions"].shape == (3, 2, 1)
    p = tb.init(torch.Generator().manual_seed(1))
    assert torch.isfinite(tb.loss(p, pf))


def test_launchers_run_qwen2_vl_on_the_cpu():
    """``launch/train.py --arch qwen2-vl-7b --reduced --device cpu`` (the
    token stream: the embed path) for 2 protocol steps at G = 4, and
    ``launch/serve.py`` (16 merged embeddings at [3, B, S] ids, then 4
    decode steps at the next ids)."""
    from repro_torch.launch import train
    run = train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--steps", "2", "--groups", "4", "--seq", "16",
                      "--batch-per-group", "2", "--T", "2",
                      "--log-every", "1"])
    assert run.state.t == 2
    assert np.all(np.isfinite([loss for _, loss in run.losses]))
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prefill", "16", "--decode", "4"])
    assert out.shape == (2, 5) and int(out.max()) < run.bundle.cfg.vocab

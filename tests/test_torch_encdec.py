"""The port's encoder-decoder (``repro_torch.models.encdec``, whisper-small)
against the JAX package's ``repro.models.encdec`` on shared numpy params
and frames, reduced (2 + 2 layers, d_model 128, 4 heads of 32,
``max_source_len`` 64) with float32 activations: the sinusoid table, the
GELU MLP (float32 and bf16), the encoder, the loss and every leaf's
gradient, and prefill plus decode, where the cross K/V cover exactly the
frames given (50 here), not the ``max_source_len`` allocation. Single
functions: rtol / atol 1e-5; whole models and gradients 1e-4 (gradients:
atol scaled by the largest); bf16: one bf16 step at the output's
largest magnitude. The serving launcher runs it on the CPU; the training
launcher refuses it with the reason."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, jax_tree, np_dtype_cast, numpy_params
from repro.models import encdec as jencdec
from repro.models import layers as jlayers
from repro.models.registry import get_bundle as jax_bundle
from repro_torch.models import encdec, layers
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_bundle

ARCH = "whisper-small"
OVER = dict(act_dtype="float32")
SE = 50          # frames: fewer than max_source_len (64)


def _bundles():
    return (jax_bundle(ARCH, reduced=True, **OVER),
            get_bundle(ARCH, reduced=True, **OVER))


def _frames(rng, B=2, S=SE, D=128):
    return (0.5 * rng.standard_normal((B, S, D))).astype(np.float32)


@pytest.mark.parametrize("length,d", [(1500, 768), (SE, 128)])
def test_sinusoids_equal_jax(length, d):
    """Computed in float64 and rounded once to float32: bit-equal."""
    np.testing.assert_array_equal(encdec.sinusoids(length, d).numpy(),
                                  np.asarray(jencdec.sinusoids(length, d)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp_matches_jax(dtype):
    """``jax.nn.gelu``'s tanh approximation, with both biases."""
    rng = np.random.default_rng(1)
    p = {"w_up": rng.standard_normal((32, 64)) / 6,
         "b_up": 0.1 * rng.standard_normal(64),
         "w_down": rng.standard_normal((64, 32)) / 8,
         "b_down": 0.1 * rng.standard_normal(32)}
    x = rng.standard_normal((3, 5, 32))
    jx, tx = np_dtype_cast(x, dtype)
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.astype(np.float32)) for k, v in p.items()}
    want = np.asarray(jlayers.gelu_mlp(jp, jx, getattr(jnp, dtype))
                      .astype(jnp.float32))
    got = layers.gelu_mlp(tp, tx, getattr(torch, dtype)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        # one bf16 step at the output's largest magnitude: XLA rounds the
        # tanh form's intermediates to bf16 (1 + tanh cancels in the tail)
        step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got, want, rtol=0, atol=step)
    erf = torch.nn.functional.gelu(torch.tensor([1.0])).item()
    tanh = torch.nn.functional.gelu(torch.tensor([1.0]),
                                    approximate="tanh").item()
    assert abs(float(jax.nn.gelu(1.0)) - tanh) < 1e-7 < abs(erf - tanh)


def test_encode_matches_jax():
    jb, tb = _bundles()
    p_np = numpy_params(jb.cfg, seed=2)
    fr = _frames(np.random.default_rng(3))
    want = jax.jit(lambda p, f: jencdec.encode(p, f, cfg=jb.cfg))(
        jax_tree(p_np), jnp.asarray(fr))
    got = encdec.encode(params_from_jax(p_np, tb.cfg, device=CPU),
                        torch.from_numpy(fr), cfg=tb.cfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_loss_and_grads_match_jax():
    """Frames and 40 tokens: the loss and every leaf's gradient (the
    encoder's through the cross K/V; ``pos_dec``'s first 40 rows)."""
    jb, tb = _bundles()
    p_np = numpy_params(jb.cfg, seed=4)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jb.cfg.vocab, (2, 41)).astype(np.int32)
    batch = {"enc_frames": _frames(rng), "tokens": toks[:, :-1],
             "labels": toks[:, 1:]}
    jl, jg = jax.jit(jax.value_and_grad(jb.loss))(
        jax_tree(p_np), {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = {}

    def track(t, path=""):
        if isinstance(t, dict):
            return {k: track(v, f"{path}/{k}") for k, v in t.items()}
        leaves[path] = t.requires_grad_()
        return t

    tl = tb.loss(track(params_from_jax(p_np, tb.cfg, device=CPU)),
                 {k: torch.from_numpy(v) if v.dtype == np.float32
                  else torch.from_numpy(v).long() for k, v in batch.items()})
    tl.backward()
    assert abs(tl.item() - float(jl)) < 1e-5
    assert np.abs(np.asarray(jg["enc_blocks"]["attn"]["wq"])).max() > 0
    for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]:
        key = "".join(f"/{p.key}" for p in path)
        want = np.asarray(g)
        np.testing.assert_allclose(leaves[key].grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=key)


def test_prefill_and_decode_match_jax():
    """Prefill of 50 frames and 9 tokens, then 3 decode steps: logits
    against JAX's; the cross K/V cover the 50 frames (the 64-frame
    allocation replaced), in the activation dtype, as JAX's."""
    jb, tb = _bundles()
    p_np = numpy_params(jb.cfg, seed=6)
    jp, tp = jax_tree(p_np), params_from_jax(p_np, tb.cfg, device=CPU)
    rng = np.random.default_rng(7)
    fr = _frames(rng)
    toks = rng.integers(0, jb.cfg.vocab, (2, 9)).astype(np.int32)
    steps = rng.integers(0, jb.cfg.vocab, (3, 2, 1)).astype(np.int32)
    # float32 self-attention caches (bf16 rounding of values that differ
    # in the last float32 bits would round a few apart)
    jc = jb.init_caches(2, max_len=32, n_chunks=4, dtype=jnp.float32)
    tc = tb.init_caches(2, max_len=32, n_chunks=4, dtype=torch.float32,
                        device=CPU)
    assert tc.cross_k.shape == (2, 2, 64, 4, 32)
    jl, jc = jax.jit(jb.prefill)(jp, {"enc_frames": jnp.asarray(fr),
                                      "tokens": jnp.asarray(toks)}, jc)
    jdec = jax.jit(jb.decode)
    with torch.inference_mode():
        tl, tc = tb.prefill(tp, {"enc_frames": torch.from_numpy(fr),
                                 "tokens": torch.from_numpy(toks).long()}, tc)
        assert tc.cross_k.shape == jc.cross_k.shape == (2, 2, SE, 4, 32)
        assert tc.cross_v.dtype == torch.float32
        np.testing.assert_allclose(tc.cross_v.numpy(), np.asarray(jc.cross_v),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        for t in steps:
            jl, jc = jdec(jp, jc, {"token": jnp.asarray(t)})
            tl, tc = tb.decode(tp, tc, {"token": torch.from_numpy(t).long()})
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                       atol=1e-4)
    assert tc.self_kv.length.tolist() == [[12, 12]] * 2


def test_decode_positions_are_per_row():
    """Two rows prefilled alone at different lengths, then decoded
    together: each row's learned position is its own (the logits equal
    each row's single-row decode)."""
    _, tb = _bundles()
    tp = params_from_jax(numpy_params(tb.cfg, seed=8), tb.cfg, device=CPU)
    fr = torch.from_numpy(_frames(np.random.default_rng(9), B=1))
    prompts = [[5, 9, 2, 7, 1], [3, 8]]
    tok = {"token": torch.tensor([[4]])}

    def prefilled(prompt):
        c = tb.init_caches(1, 16, 4, dtype=torch.float32, device=CPU)
        return tb.prefill(tp, {"enc_frames": fr,
                               "tokens": torch.tensor([prompt])}, c)[1]

    with torch.inference_mode():
        alone = [tb.decode(tp, prefilled(pr), tok)[0][0] for pr in prompts]
        a, b = (prefilled(pr) for pr in prompts)
        both = encdec.EncDecCaches(
            type(a.self_kv)(*(torch.cat(ts, 1)
                              for ts in zip(a.self_kv, b.self_kv))),
            torch.cat([a.cross_k, b.cross_k], 1),
            torch.cat([a.cross_v, b.cross_v], 1))
        lg, both = tb.decode(tp, both, {"token": torch.tensor([[4], [4]])})
    torch.testing.assert_close(lg, torch.stack(alone), rtol=1e-5, atol=1e-5)
    assert both.self_kv.length.tolist() == [[6, 3]] * 2


def test_bundle_init_matches_the_jax_tree():
    jb, tb = _bundles()
    want = jax.tree.map(lambda l: tuple(l.shape),
                        jax.eval_shape(jb.init, jax.random.PRNGKey(0)))
    got = tb.init(torch.Generator().manual_seed(0))

    def shapes(t):
        return ({k: shapes(v) for k, v in t.items()} if isinstance(t, dict)
                else tuple(t.shape))
    assert shapes(got) == want
    batch = tb.make_batch("train", 2, 32, torch.Generator().manual_seed(1))
    assert batch["enc_frames"].shape == (2, 16, 128)
    assert batch["tokens"].shape == batch["labels"].shape == (2, 16)
    assert torch.isfinite(tb.loss(got, batch))


def test_launchers_serve_whisper_and_refuse_to_train_it():
    """``launch/serve.py --arch whisper-small --reduced --device cpu``
    prefills the batch's 8 frames and 8 tokens and decodes 4 steps;
    ``launch/train.py`` refuses it up front with the reason (its loss
    reads encoder frames, which the token stream does not carry)."""
    from repro_torch.launch import serve, train
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prefill", "16", "--decode", "4"])
    assert out.shape == (2, 5) and int(out.max()) < 512
    with pytest.raises(ValueError, match="enc_frames"):
        train.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--steps", "1"])

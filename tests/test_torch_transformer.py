"""Port's dense transformer (prefill + decode) vs the JAX package on the
same numpy-drawn params converted with ``params_from_jax``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, jax_tree, numpy_params
from repro.models.registry import get_bundle as jax_bundle
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import ModelBundle, get_bundle
from repro_torch.models.transformer import cache_rows

# f32: the same f32 arithmetic in another summation order (seen: 1.4e-6).
# bf16: both packages round activations to bf16 at every matmul, in other
# orders, over 2 layers (seen: 8e-3 on logits of scale 0.8); 2e-2 is about
# five bf16 steps at that scale.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S, STEPS = 2, 20, 3


@pytest.mark.parametrize("act_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_jax(act_dtype):
    # q_block/kv_block 8: the CPU blocked path runs several ragged blocks
    over = dict(act_dtype=act_dtype, q_block=8, kv_block=8)
    jb = jax_bundle("phi4-mini-3.8b", reduced=True, **over)
    tb = get_bundle("phi4-mini-3.8b", reduced=True, **over)
    assert tb.cfg == type(tb.cfg)(**jb.cfg.__dict__)
    p_np = numpy_params(jb.cfg, seed=1)
    jp = jax_tree(p_np)
    tp = params_from_jax(p_np, tb.cfg, device=CPU)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jb.cfg.vocab, (B, S)).astype(np.int32)
    steps = rng.integers(0, jb.cfg.vocab, (STEPS, B, 1)).astype(np.int32)
    max_len = S + STEPS + 1

    jc = jb.init_caches(B, max_len=max_len, n_chunks=4)
    tc = tb.init_caches(B, max_len=max_len, n_chunks=4, device=CPU)
    jl, jc = jax.jit(jb.prefill)(jp, {"tokens": jnp.asarray(toks)}, jc)
    with torch.inference_mode():
        tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, tc)
    tol = TOL[act_dtype]
    assert tl.dtype == torch.float32 and tl.shape == (B, jb.cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol, atol=tol)
    np.testing.assert_array_equal(tc.length.numpy(), S)

    jdec = jax.jit(jb.decode)
    for t in steps:
        jl, jc = jdec(jp, jc, {"token": jnp.asarray(t)})
        with torch.inference_mode():
            tl, tc = tb.decode(tp, tc, {"token": torch.from_numpy(t).long()})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=tol,
                                   atol=tol)
    # the caches are bf16 in both. f32 activations: values within 1e-4 may
    # round to neighbouring bf16 values (seen: 4.9e-4). bf16 activations:
    # k of magnitude up to 4 differs by a few bf16 steps of 2^-6 (seen:
    # 0.039); 2^-4 is four such steps.
    cache_tol = {"float32": 2 ** -7, "bfloat16": 2 ** -4}[act_dtype]
    np.testing.assert_allclose(tc.k.float().numpy(),
                               np.asarray(jc.k.astype(jnp.float32)),
                               rtol=cache_tol, atol=cache_tol)


def test_rows_decode_at_independent_positions():
    """Per-row cache lengths: a batch of two rows at different positions
    decodes each row exactly as it would alone."""
    tb = get_bundle("phi4-mini-3.8b", reduced=True, act_dtype="float32")
    p = params_from_jax(numpy_params(tb.cfg, 3), tb.cfg, device=CPU)
    prompts = [[5, 9, 2, 7, 1], [3, 8]]
    alone = []
    for pr in prompts:
        c = tb.init_caches(1, max_len=16, n_chunks=4, device=CPU)
        tb.prefill(p, {"tokens": torch.tensor([pr])}, c)
        alone.append(tb.decode(p, c, {"token": torch.tensor([[4]])})[0][0])
    c = tb.init_caches(2, max_len=16, n_chunks=4, device=CPU)
    for r, pr in enumerate(prompts):
        tb.prefill(p, {"tokens": torch.tensor([pr])},
                   cache_rows(c, slice(r, r + 1)))
    both, c = tb.decode(p, c, {"token": torch.tensor([[4], [4]])})
    torch.testing.assert_close(both, torch.stack(alone), rtol=1e-5, atol=1e-5)
    assert c.length[:, 0].tolist() == [6] * tb.cfg.n_layers
    assert c.length[:, 1].tolist() == [3] * tb.cfg.n_layers


def test_unported_arch_and_family_raise():
    """Every arch of the reference is ported: an arch or a family the
    registry does not know raises, as does a cache that does not split."""
    with pytest.raises(ValueError, match="unknown arch"):
        get_bundle("qwen2-vl-72b")
    cfg = dataclasses.replace(get_bundle("phi4-mini-3.8b").cfg,
                              family="diffusion")
    with pytest.raises(ValueError, match="unknown model family"):
        ModelBundle(cfg)
    with pytest.raises(ValueError, match="divisible"):
        get_bundle("phi4-mini-3.8b", reduced=True).init_caches(
            1, max_len=10, n_chunks=4, device=CPU)


def test_init_shapes_match_jax_tree():
    jb = jax_bundle("phi4-mini-3.8b", reduced=True)
    tb = get_bundle("phi4-mini-3.8b", reduced=True)
    want = jax.tree.map(lambda l: tuple(l.shape),
                        jax.eval_shape(jb.init, jax.random.PRNGKey(0)))
    got = tb.init(torch.Generator().manual_seed(0), dtype=torch.bfloat16)

    def shapes(t):
        return ({k: shapes(v) for k, v in t.items()} if isinstance(t, dict)
                else tuple(t.shape))
    assert shapes(got) == want
    assert got["blocks"]["attn"]["wq"].dtype == torch.bfloat16


def _layer_case(name, rng):
    """(jax result, port result, tol) of one layer function on shared
    numpy inputs."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    def both(*shape, scale=1.0):
        a = (scale * rng.standard_normal(shape)).astype(np.float32)
        return jnp.asarray(a), torch.from_numpy(a)

    if name == "rmsnorm":
        (jx, tx), (js, ts) = both(2, 5, 16), both(16)
        return (JL.rmsnorm({"scale": js}, jx), TL.rmsnorm({"scale": ts}, tx),
                1e-6)
    if name == "apply_rope":
        jx, tx = both(2, 7, 3, 8)
        pos = rng.integers(0, 50, (2, 7))
        return (JL.apply_rope(jx, jnp.asarray(pos), 1e4),
                TL.apply_rope(tx, torch.from_numpy(pos), 1e4), 1e-5)
    if name == "swiglu":
        (jx, tx), (jg, tg), (ju, tu), (jd, td) = (
            both(2, 3, 8), both(8, 16), both(8, 16), both(16, 8))
        return (JL.swiglu({"w_gate": jg, "w_up": ju, "w_down": jd}, jx,
                          jnp.float32),
                TL.swiglu({"w_gate": tg, "w_up": tu, "w_down": td}, tx,
                          torch.float32), 1e-5)
    if name == "unembed_bf16":
        (jx, tx), (jt, tt) = both(2, 3, 16), both(40, 16)
        return (JL.unembed({"table": jt.astype(jnp.bfloat16)},
                           jx.astype(jnp.bfloat16)),
                TL.unembed({"table": tt.bfloat16()}, tx.bfloat16()), 1e-5)
    if name.startswith("flash_decode"):
        window = 5 if name.endswith("window") else 0
        (jq, tq), (jk, tk), (jv, tv) = both(2, 1, 4, 8), both(
            2, 11, 2, 8), both(2, 11, 2, 8)
        jc = JL.cache_prefill(JL.KVCache.create(2, 2, 16, 8, 4, jnp.float32),
                              jk, jv)
        tc = TL.cache_prefill(TL.KVCache.create(2, 2, 16, 8, 4,
                                                torch.float32), tk, tv)
        (jn, tn) = both(2, 1, 2, 8)
        jc = JL.cache_insert(jc, jn, jn)
        tc = TL.cache_insert(tc, tn, tn)
        return (JL.flash_decode(jq, jc, window=window),
                TL.flash_decode(tq, tc, window=window), 1e-5)
    raise ValueError(name)


@pytest.mark.parametrize("name", ["rmsnorm", "apply_rope", "swiglu",
                                  "unembed_bf16", "flash_decode",
                                  "flash_decode_window"])
def test_layer_functions_match_jax(name):
    """f32 (and bf16-operand, f32-output unembed): same arithmetic, other
    summation order; tolerances are a few f32 ulps of the outputs' scale."""
    want, got, tol = _layer_case(name, np.random.default_rng(7))
    if isinstance(got, torch.Tensor) and got.dtype == torch.float32:
        assert np.asarray(want).dtype == np.float32
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)

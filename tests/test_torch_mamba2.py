"""The port's Mamba2 block (``repro_torch.models.mamba2``) against the JAX
package's ``repro.models.mamba2`` on shared numpy inputs: the causal conv
with and without a state, the chunked SSD scan at a length that pads from
a non-zero state, the whole block in training and with a cache, the
single-step decode recurrence against the chunked scan, the states carried
between chunks against a step-by-step float64 recurrence after a large
cumulative decay, and a NaN-free backward with decays at the floor. float32 throughout: rtol / atol 1e-5
for single functions (the same arithmetic in other orders), 1e-4 for
gradients and for 21 steps of the recurrence against one scan."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_tree, numpy_params
from repro.models import mamba2 as jm
from repro.models.registry import get_bundle as jax_bundle
from repro_torch.models import mamba2 as tm
from repro_torch.models.registry import get_bundle

ARCH = "zamba2-1.2b"
TOL = dict(rtol=1e-5, atol=1e-5)


def _a(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(kw or TOL))


def _block_params(cfg, seed):
    """Layer 0 of a numpy hybrid tree's Mamba2 stack."""
    tree = numpy_params(cfg, seed)["mamba"]
    return {k: ({a: b[0] for a, b in v.items()} if isinstance(v, dict)
                else v[0]) for k, v in tree.items()}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(0)
    x, w, b = _a(rng, 2, 9, 6), _a(rng, 4, 6), _a(rng, 6)
    state = _a(rng, 2, 3, 6) if with_state else None
    jy, js = jm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             None if state is None else jnp.asarray(state))
    ty, ts = tm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b),
                             None if state is None
                             else torch.from_numpy(state))
    _close(ty, jy)
    _close(ts, js)
    assert ts.shape == (2, 3, 6)


def _scan_inputs(rng, B=2, S=100, H=3, P=4, N=5):
    la = np.maximum(-np.exp(_a(rng, B, S, H, scale=0.7)), -20.0)
    return (_a(rng, B, S, H, P), la.astype(np.float32), _a(rng, B, S, N),
            _a(rng, B, S, N), _a(rng, B, H, P, N, scale=0.5))


def test_ssd_chunked_pads_and_matches_jax():
    """S = 100 in chunks of 64 (the second padded), from a non-zero h0:
    y and the final state against JAX's ``lax.scan``; the padded steps
    leave the state as the unpadded scan (S = 128, no padding, the same
    first 100 steps then 28 zero-input steps of no decay) leaves it."""
    args = _scan_inputs(np.random.default_rng(1))
    jy, jh = jm.ssd_chunked(*(jnp.asarray(x) for x in args), chunk=64)
    ty, th = tm.ssd_chunked(*(torch.from_numpy(x) for x in args), chunk=64)
    assert ty.shape == (2, 100, 3, 4) and th.shape == (2, 3, 4, 5)
    _close(ty, jy)
    _close(th, jh)
    xh, la, Bm, Cm, h0 = (torch.from_numpy(x) for x in args)
    z = torch.zeros

    def ext(t):
        return torch.cat([t, z((2, 28) + t.shape[2:])], dim=1)
    _, th128 = tm.ssd_chunked(ext(xh), ext(la), ext(Bm), ext(Cm), h0, 64)
    torch.testing.assert_close(th, th128, rtol=1e-6, atol=1e-6)


def test_chunk_states_hold_after_a_large_cumulative_decay():
    """``ssd_chunked`` over 24 chunks whose first four decay by ~1,000 in
    log and the rest by ~0.1 a chunk, against the step-by-step recurrence
    in float64: the states entering late chunks are summed along their own
    segments, so the ~1e-4 error of a difference of two cumulative sums
    of ~1,000 does not reach them."""
    rng = np.random.default_rng(5)
    B, S, H, P, N = 1, 24 * 64, 2, 4, 8
    la = np.full((B, S, H), -0.002)
    la[:, :256] = -4.0
    xh, Bm, Cm = (_a(rng, *s) for s in ((B, S, H, P), (B, S, N), (B, S, N)))
    h0 = _a(rng, B, H, P, N)
    y, h = tm.ssd_chunked(*(torch.from_numpy(np.asarray(t, np.float32))
                            for t in (xh, la, Bm, Cm, h0)), 64)
    hh, ys = h0.astype(np.float64), []
    for t in range(S):
        hh = (np.exp(la[:, t])[..., None, None] * hh
              + np.einsum("bhp,bn->bhpn", xh[:, t], Bm[:, t]))
        ys.append(np.einsum("bn,bhpn->bhp", Cm[:, t], hh))
    _close(h, hh, rtol=1e-5, atol=1e-5 * np.abs(hh).max())
    want = np.stack(ys, 1)
    _close(y, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_decode_recurrence_equals_the_chunked_scan():
    """``mamba_block`` over 21 tokens in one call (the chunked scan) and
    one token at a time with a cache (the single-step recurrence): the
    same outputs and final state; and one cached step against JAX's."""
    cfg = get_bundle(ARCH, reduced=True, act_dtype="float32").cfg
    jcfg = jax_bundle(ARCH, reduced=True, act_dtype="float32").cfg
    p_np = _block_params(cfg, 2)
    tp = _torch(p_np)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_a(rng, 2, 21, cfg.d_model))
    c0 = tm.init_cache(cfg, 2, torch.float32)
    whole, cw = tm.mamba_block(tp, x, cfg, torch.float32, c0)
    c, steps = c0, []
    for t in range(21):
        out, c = tm.mamba_block(tp, x[:, t:t + 1], cfg, torch.float32, c)
        steps.append(out)
    torch.testing.assert_close(torch.cat(steps, 1), whole, rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(c.ssm, cw.ssm, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(c.conv, cw.conv, rtol=0, atol=0)
    xn = _a(rng, 2, 1, cfg.d_model)
    jc = jm.MambaCache(*(jnp.asarray(t.numpy()) for t in c))
    jout, jnew = jm.mamba_block(jax_tree(p_np), jnp.asarray(xn), jcfg,
                                jnp.float32, jc)
    tout, tnew = tm.mamba_block(tp, torch.from_numpy(xn), cfg,
                                torch.float32, c)
    _close(tout, jout)
    _close(tnew.ssm, jnew.ssm)
    _close(tnew.conv, jnew.conv)


@pytest.mark.parametrize("cached", [False, True])
def test_mamba_block_matches_jax(cached):
    """The whole block over S = 70 (two chunks, the second padded):
    training (zero state, no cache out) and prefill from a non-zero cache
    (conv window and SSM state), output and the new cache."""
    cfg = get_bundle(ARCH, reduced=True, act_dtype="float32").cfg
    jcfg = jax_bundle(ARCH, reduced=True, act_dtype="float32").cfg
    p_np = _block_params(cfg, 4)
    rng = np.random.default_rng(5)
    x = _a(rng, 2, 70, cfg.d_model)
    d_inner, H, P, N = tm.dims(cfg)
    conv = _a(rng, 2, cfg.ssm_conv - 1, d_inner + 2 * N)
    ssm = _a(rng, 2, H, P, N, scale=0.3)
    jc = jm.MambaCache(jnp.asarray(conv), jnp.asarray(ssm)) if cached \
        else None
    tc = tm.MambaCache(torch.from_numpy(conv), torch.from_numpy(ssm)) \
        if cached else None
    jout, jnew = jm.mamba_block(jax_tree(p_np), jnp.asarray(x), jcfg,
                                jnp.float32, jc)
    tout, tnew = tm.mamba_block(_torch(p_np), torch.from_numpy(x), cfg,
                                torch.float32, tc)
    _close(tout, jout, rtol=1e-5, atol=2e-5)
    assert (tnew is None) == (jnew is None) == (not cached)
    if cached:
        _close(tnew.ssm, jnew.ssm, rtol=1e-5, atol=2e-5)
        _close(tnew.conv, jnew.conv)


def test_backward_is_nan_free_with_decays_at_the_floor():
    """Half the steps' decays exactly at the floor (log decay -20, a tie
    of the floor's maximum: above the diagonal the unmasked decay matrix
    would reach exp(20 x 63)) over two chunks: the scan's gradients are
    finite and equal ``jax.grad``'s, the tie's split included."""
    rng = np.random.default_rng(6)
    xh, la, Bm, Cm, h0 = _scan_inputs(rng, S=128)
    la = np.where(rng.uniform(size=la.shape) < 0.5, np.float32(-20.0), la)

    def jloss(xh, la, Bm, Cm, h0):
        y, h = jm.ssd_chunked(xh, jnp.maximum(la, -20.0), Bm, Cm, h0, 64)
        return jnp.sum(y ** 2) + jnp.sum(h)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(x) for x in (xh, la, Bm, Cm, h0)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (xh, la, Bm, Cm, h0)]
    floored = torch.maximum(ts[1], ts[1].new_tensor(tm.LOG_DECAY_FLOOR))
    y, h = tm.ssd_chunked(ts[0], floored, *ts[2:], 64)
    (torch.sum(y ** 2) + torch.sum(h)).backward()
    for t, g in zip(ts, jg):
        assert torch.isfinite(t.grad).all()
        want = np.asarray(g)
        # gradients: 1e-4, atol scaled by the largest (the log decays'
        # come out of a reverse cumulative sum, in float32)
        np.testing.assert_allclose(t.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())

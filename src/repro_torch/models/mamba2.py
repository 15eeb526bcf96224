"""Mamba2 (SSD) block (PyTorch port of ``repro.models.mamba2``), the
backbone of the hybrid family (zamba2-1.2b); its mixer alone
(:func:`mamba_mixer`, no norm or residual) is a layer of the
``granite_hybrid`` family, which scales the mixer's branch.

State recurrence (per head h, head dim P, state N):
    h_t = a_t * h_{t-1} + (dt_t * x_t) outer B_t,   a_t = exp(-exp(A_log) dt_t)
    y_t = C_t . h_t + D_skip * x_t
Training and prefill run :func:`ssd_chunked`, the reference's chunked
closed form: the intra-chunk term a masked ``[C, C]`` decay matrix per
head, the inter-chunk term one contraction with the state entering the
chunk. A one-token call with a cache runs the single-step recurrence.

Where a straightforward port would differ from the reference:
  * the decay matrix ``exp(L_t - L_j)`` is masked to ``-inf`` *before* the
    ``exp``: above the diagonal the difference is positive (up to 63 x 20),
    and ``exp`` of it overflows, so masking after would give ``inf * 0 =
    NaN`` in the forward or in autograd's backward;
  * ``softplus`` is ``logaddexp(x, 0)``, as ``jax.nn.softplus`` (``F.
    softplus`` switches to ``x`` above its threshold of 20);
  * the decay floor is ``torch.maximum`` against a tensor, whose gradient
    splits a tie as ``jnp.maximum``'s (``clamp`` would pass it whole);
  * the causal conv sums its K shifted terms in the reference's order.
Every term of the chunked scan is computed for all chunks at once: the
state entering each chunk too, as one contraction of the chunks' state
increments with the decays between chunks (:func:`_segsum`), where the
reference carries it by a scan over the chunks.

Tensor parallelism (the 'model' axis): ``in_proj`` and ``out_proj`` are
row-parallel (D and d_inner over 'model'), each a partial product and
one reduction, so the whole ``[.., 2 d_inner + 2N + H]`` projection is on
every rank; the conv, the SSD scan and the gated norm run whole on each
rank, on the small leaves (the conv, ``A_log``, ``dt_bias``,
``D_skip``, the norm scales) gathered whole at use, and the state (conv
window and SSD state) stays whole on every rank.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..spans import span
from . import layers as L
from .config import ArchConfig

LOG_DECAY_FLOOR = -20.0  # exp(-20) ~ 2e-9: numerically zero decay


class MambaCache(NamedTuple):
    conv: torch.Tensor   # [B, convw-1, conv_channels] rolling window
    ssm: torch.Tensor    # [B, H, P, N] float32


def dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    H = d_inner // P
    N = cfg.ssm_state
    return d_inner, H, P, N


def init_mamba_blocks(gen: torch.Generator, cfg: ArchConfig, dtype):
    """``n_layers`` Mamba2 blocks, stacked ``[L, ...]``, by the reference's
    laws: the projections ``truncated_normal / sqrt(fan_in)``, ``conv_w``
    ``0.1 * normal``, ``A_log`` 0, ``dt_bias`` -2, ``D_skip`` 1."""
    d_inner, H, P, N = dims(cfg)
    Lyr, D, dev = cfg.n_layers, cfg.d_model, gen.device
    conv_ch = d_inner + 2 * N

    def full(value, *shape):
        return torch.full((Lyr,) + shape, value, dtype=dtype, device=dev)

    return {
        "ln": {"scale": full(1.0, D)},
        "in_proj": L.init_dense(gen, D, (Lyr, D, 2 * d_inner + 2 * N + H),
                                dtype),
        "conv_w": (0.1 * torch.randn((Lyr, cfg.ssm_conv, conv_ch),
                                     generator=gen, device=dev)).to(dtype),
        "conv_b": full(0.0, conv_ch),
        "A_log": full(0.0, H),
        "dt_bias": full(-2.0, H),
        "D_skip": full(1.0, H),
        "gate_ln": {"scale": full(1.0, d_inner)},
        "out_proj": L.init_dense(gen, d_inner, (Lyr, d_inner, D), dtype),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv by static shifts. x: [B, S, C]; w: [K, C];
    state: [B, K-1, C] the previous tokens, or None (zero history).
    Returns (y, new_state); the window is in the promoted dtype of ``x``
    and ``state``, as the reference's concatenation gives it."""
    K = w.shape[0]
    B, S, C = x.shape
    if state is None:
        state = x.new_zeros((B, K - 1, C))
    dt = torch.promote_types(state.dtype, x.dtype)
    xx = torch.cat([state.to(dt), x.to(dt)], dim=1)      # [B, S+K-1, C]
    y = 0
    for i in range(K):
        y = y + xx[:, i:i + S] * w[K - 1 - i].to(x.dtype)
    new_state = xx[:, -(K - 1):] if K > 1 else state
    return F.silu(y + b.to(x.dtype)), new_state


def _split_proj(p, x, cfg: ArchConfig, dtype):
    d_inner, H, P, N = dims(cfg)
    proj = L.row_parallel(x, p["in_proj"].to(dtype))
    z = proj[..., :d_inner]
    xc = proj[..., d_inner:2 * d_inner]
    Bm = proj[..., 2 * d_inner:2 * d_inner + N]
    Cm = proj[..., 2 * d_inner + N:2 * d_inner + 2 * N]
    dt = proj[..., 2 * d_inner + 2 * N:]
    return z, xc, Bm, Cm, dt


def _segsum(x):
    """x ``[..., T]`` -> ``[..., T, T]``: ``x[j+1] + ... + x[i]`` at
    ``[i, j]`` for j <= i (0 on the diagonal), ``-inf`` above it. Each
    entry is summed along its own segment, not taken as the difference of
    two cumulative sums, which cancels once the sums are large."""
    T = x.shape[-1]
    ones = torch.ones((T, T), dtype=torch.bool, device=x.device)
    below = torch.tril(ones, diagonal=-1)
    seg = torch.cumsum(x[..., :, None].expand(*x.shape, T)
                       .masked_fill(~below, 0.0), dim=-2)
    return seg.masked_fill(~torch.tril(ones), float("-inf"))


def ssd_chunked(xh, la, Bm, Cm, h0, chunk: int):
    """Chunked SSD scan. xh: [B, S, H, P] (dt-scaled inputs); la: [B, S, H]
    log decays (<= 0); Bm, Cm: [B, S, N]; h0: [B, H, P, N]. Returns
    (y [B, S, H, P] float32, the final state).

    S is padded to whole chunks with zero inputs and log decay 0 (no
    decay), which leave the state as it was. With L the inclusive
    cumulative log decay of a chunk: y_t = (C_t . h0) exp(L_t) + sum_{j<=t}
    (C_t . B_j) exp(L_t - L_j) u_j, and the state leaving the chunk is
    exp(L_C) h0 + sum_j exp(L_C - L_j) B_j (x) u_j."""
    with span("mamba2.ssd"):
        Bsz, S, H, P = xh.shape
        N = Bm.shape[-1]
        nch = -(-S // chunk)
        pad = nch * chunk - S
        if pad:
            xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
            la = F.pad(la, (0, 0, 0, pad))
            Bm = F.pad(Bm, (0, 0, 0, pad))
            Cm = F.pad(Cm, (0, 0, 0, pad))
        # [nch, B, C, ...] float32
        u = xh.float().reshape(Bsz, nch, chunk, H, P).transpose(0, 1)
        lac = la.float().reshape(Bsz, nch, chunk, H).transpose(0, 1)
        Bc = Bm.float().reshape(Bsz, nch, chunk, N).transpose(0, 1)
        Cc = Cm.float().reshape(Bsz, nch, chunk, N).transpose(0, 1)

        causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                       device=xh.device))
        Lc = torch.cumsum(lac, dim=2)                        # inclusive
        G = torch.einsum("zbin,zbjn->zbij", Cc, Bc)          # [nch, B, C, C]
        Dm = Lc[:, :, :, None, :] - Lc[:, :, None, :, :]  # [nch, B, C, C, H]
        Dm = torch.where(causal[:, :, None], Dm, float("-inf"))   # before exp
        M = G[..., None] * torch.exp(Dm)
        y_intra = torch.einsum("zbijh,zbjhp->zbihp", M, u)
        wdec = torch.exp(Lc[:, :, -1:, :] - Lc)              # [nch, B, C, H]
        add = torch.einsum("zbjn,zbjhp,zbjh->zbhpn", Bc, u, wdec)
        # the state entering chunk i, i = 0..nch (nch: the final state):
        # sum_{j<=i} exp(log decay of chunks j..i-1) s_j, with s_0 = h0 and
        # s_j the increment of chunk j-1
        seg = _segsum(F.pad(Lc[:, :, -1, :].permute(1, 2, 0), (1, 0)))
        states = torch.cat([h0.float()[None], add])    # [nch+1, B, H, P, N]
        hs = torch.einsum("bhij,jbhpn->ibhpn", torch.exp(seg), states)
        tmp = torch.einsum("zbcn,zbhpn->zbchp", Cc, hs[:-1])
        y = tmp * torch.exp(Lc)[..., None] + y_intra
        y = y.transpose(0, 1).reshape(Bsz, nch * chunk, H, P)
        return y[:, :S], hs[-1]


def _small_leaves(cfg: ArchConfig) -> dict:
    """The mixer's small leaves (path -> whole shape), gathered whole at
    use."""
    d_inner, H, P, N = dims(cfg)
    conv_ch = d_inner + 2 * N
    return {"conv_w": (cfg.ssm_conv, conv_ch), "conv_b": (conv_ch,),
            "A_log": (H,), "dt_bias": (H,), "D_skip": (H,),
            "gate_ln/scale": (d_inner,)}


def mamba_mixer(p, h, cfg: ArchConfig, dtype,
                cache: MambaCache | None = None, chunk: int = 64):
    """The Mamba2 mixer on normed inputs, without norm or residual: h
    ``[B, S, D]`` -> (``[B, S, D]``, new cache), under the span
    ``mamba2.mixer`` (``mamba2.ssd`` inside). ``cache`` None is training
    (zero state, no cache out); a cache is prefill or decode, carrying its
    state (a one-token call runs the single-step recurrence)."""
    with span("mamba2.mixer"):
        d_inner, H, P, N = dims(cfg)
        p = L.whole_leaves(p, _small_leaves(cfg))
        z, xc, Bm, Cm, dt = _split_proj(p, h, cfg, dtype)
        conv_in = torch.cat([xc, Bm, Cm], dim=-1)
        conv_state = cache.conv if cache is not None else None
        conv_out, new_conv = _causal_conv(conv_in, p["conv_w"], p["conv_b"],
                                          conv_state)
        xc = conv_out[..., :d_inner]
        Bm = conv_out[..., d_inner:d_inner + N]
        Cm = conv_out[..., d_inner + N:]

        dtf = dt.float() + p["dt_bias"]
        dt_act = torch.logaddexp(dtf, torch.zeros_like(dtf))     # softplus
        la = torch.maximum(-torch.exp(p["A_log"]) * dt_act,
                           dt_act.new_tensor(LOG_DECAY_FLOOR))   # [B, S, H]
        xh = xc.reshape(*xc.shape[:2], H, P)
        u = xh.float() * dt_act[..., None]

        B_, S = h.shape[0], h.shape[1]
        h0 = (cache.ssm if cache is not None
              else torch.zeros((B_, H, P, N), dtype=torch.float32,
                               device=h.device))
        if S == 1 and cache is not None:   # decode: the single-step recurrence
            a = torch.exp(la[:, 0])                                  # [B, H]
            h_new = (a[..., None, None] * h0
                     + torch.einsum("bhp,bn->bhpn", u[:, 0],
                                    Bm[:, 0].float()))
            y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(),
                             h_new)[:, None]
            h_fin = h_new
        else:
            y, h_fin = ssd_chunked(u, la, Bm, Cm, h0, chunk)
        y = y + p["D_skip"][None, None, :, None] * xh.float()
        y = y.reshape(B_, S, d_inner).to(dtype)
        y = L.rmsnorm(p["gate_ln"], y * F.silu(z), cfg.norm_eps)
        out = L.row_parallel(y, p["out_proj"].to(dtype))
        new_cache = MambaCache(new_conv, h_fin) if cache is not None else None
        return out, new_cache


def mamba_block(p, x, cfg: ArchConfig, dtype, cache: MambaCache | None = None,
                chunk: int = 64):
    """x: [B, S, D] -> (x + the mixer of rmsnorm(x), new cache): the block
    of the hybrid family (zamba2), :func:`mamba_mixer` behind its norm and
    residual. ``cache`` as the mixer's."""
    # the small leaves whole, in one gather over 'model' when split (the
    # mixer then finds them whole)
    p = L.whole_leaves(p, {"ln/scale": (cfg.d_model,), **_small_leaves(cfg)})
    h = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    out, new_cache = mamba_mixer(p, h, cfg, dtype, cache, chunk)
    return x + out, new_cache


def init_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
               device=None) -> MambaCache:
    """A zero state: the conv window in ``dtype`` (the reference's cache
    dtype), the SSM state float32."""
    d_inner, H, P, N = dims(cfg)
    conv_ch = d_inner + 2 * N
    return MambaCache(
        torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                    device=device),
        torch.zeros((batch, H, P, N), dtype=torch.float32, device=device))

"""RWKV6 ("Finch"), the attention-free RNN with a data-dependent decay per
channel (PyTorch port of ``repro.models.rwkv6``; rwkv6-3b).

Per head (K = V = head dim):
    y_t = r_t . (S_{t-1} + diag(u * k_t) v_t),
    S_t = diag(d_t) S_{t-1} + k_t (x) v_t,
with d_t = exp(-exp(w_t)) and w_t = w0 + tanh(x_t A_w) B_w. Training and
prefill run ``wkv_chunked``, the reference's scan over chunks of 16 steps
whose intra-chunk decay is exact in log space; a one-token call with a
cache runs the single-step recurrence. The reference's simplification is
kept: the five token-shift weights ``mu_*`` are static per channel.

Params keep the reference's tree, blocks stacked ``[L, ...]``. The state
(:class:`RwkvCache`, stacked ``[L, B, ...]``) is updated in place, as the
port's KV cache is, and its shifts are held in the activation dtype (the
dtype the reference's state takes at its first write); the WKV state is
float32. Serving (``*_replicas``) runs each replica on its own, and its
decode runs each row (a serving slot) at B = 1 shapes, so a slot's tokens
equal its own single-request run bit for bit. ``reset_cache_rows`` zeroes
a slot's state for a new request, which the reference service does not
do (ROADMAP Queue 3).

Tensor parallelism (the 'model' axis): ``Wr`` / ``Wk`` / ``Wv`` / ``Wg``,
``Wo``, ``cWr``, ``cWv`` and the decay LoRA's ``wA`` / ``wB`` (float32;
``wB`` split on its 64 LoRA rows) are row-parallel, each a partial
product then a reduction (r, k, v and g in one, ``cWr`` and ``cWv`` in
one); ``cWk`` is column-parallel on F, so ``relu^2`` is local and feeds
``cWv``'s row-parallel product with no gather between them. The token
shifts and the WKV scan run whole on every rank, on the static
``mu_*``, ``w0``, ``u`` and norm leaves gathered whole at use, and the
state stays whole on every rank.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.wkv_scan.ops import state_scan
from ..spans import span
from . import layers as L
from . import sharding as shr
from .config import ArchConfig
from . import transformer as TF

LOG_DECAY_FLOOR = -20.0
DECAY_LORA = 64


class RwkvCache(NamedTuple):
    shift_t: torch.Tensor   # [B, D] last token entering time-mix
    shift_c: torch.Tensor   # [B, D] last token entering channel-mix
    wkv: torch.Tensor       # [B, H, K, V] float32 state


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.act_dtype)


def dims(cfg: ArchConfig):
    K = cfg.ssm_head_dim
    return cfg.d_model // K, K


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32):
    """Random params on ``gen.device`` in ``dtype``, by the reference's
    laws: ``mu_*`` uniform [0, 1), projections ``truncated_normal / sqrt
    (fan_in)``, ``w0`` ones, ``wB`` zeros, ``u`` ``0.1 * normal``."""
    Lyr, D, Fd = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, K = dims(cfg)
    dev = gen.device

    def mu():
        return torch.rand((Lyr, D), generator=gen, device=dev).to(dtype)

    def dense(fan_in, shape):
        return L.init_dense(gen, fan_in, (Lyr,) + shape, dtype)

    def norm():
        return L.init_layernorm((Lyr, D), dtype, dev)

    blocks = {
        "ln1": norm(), "ln2": norm(),
        "mu_r": mu(), "mu_k": mu(), "mu_v": mu(), "mu_w": mu(), "mu_g": mu(),
        "Wr": dense(D, (D, D)), "Wk": dense(D, (D, D)),
        "Wv": dense(D, (D, D)), "Wg": dense(D, (D, D)),
        "w0": torch.ones((Lyr, D), dtype=dtype, device=dev),
        "wA": dense(D, (D, DECAY_LORA)),
        "wB": torch.zeros((Lyr, DECAY_LORA, D), dtype=dtype, device=dev),
        "u": (0.1 * torch.randn((Lyr, H, K), generator=gen,
                                device=dev)).to(dtype),
        "ln_x": norm(),
        "Wo": dense(D, (D, D)),
        "mu_ck": mu(), "mu_cr": mu(),
        "cWk": dense(D, (D, Fd)), "cWv": dense(Fd, (Fd, D)),
        "cWr": dense(D, (D, D)),
    }
    return {"embed": L.init_embedding(gen, cfg.vocab, D, dtype),
            "blocks": blocks, "ln_f": L.init_layernorm(D, dtype, dev)}


# ---------------------------------------------------------------------------
# time mix, channel mix
# ---------------------------------------------------------------------------

def _shift(x, last):
    """Token shift: [B, S, D] -> the previous token at each position;
    last: [B, D]."""
    return torch.cat([last[:, None].to(x.dtype), x[:, :-1]], dim=1)


def wkv_chunked(r, k, v, lw, u, s0, chunk: int = 16):
    """r, k, v: [B, S, H, K]; lw: [B, S, H, K] log decays (<= 0); u: [H, K];
    s0: [B, H, K, V]. Returns (y [B, S, H, K] float32, final state).

    The reference's chunked scan (S padded with zeros, which neither decay
    nor add to the state), with L the inclusive cumulative log decay of a
    chunk: the intra term weighs pairs j < t by exp(L_{t-1} - L_j) <= 1
    (``-inf`` at and above the diagonal), the bonus adds (r_t . (u * k_t))
    v_t, and the inter term reads the state entering the chunk. Only that
    state is sequential (s' = exp(L_C) s + sum_j exp(L_C - L_j) k_j (x)
    v_j), so the terms that do not read it are computed for every chunk at
    once, and the recurrence over the chunks is :func:`state_scan`: one
    kernel launch forward and one backward on the card."""
    with span("rwkv6.wkv"):
        B, S, H, K = r.shape
        nch = -(-S // chunk)
        pad = nch * chunk - S
        if pad:
            r, k, v, lw = (F.pad(a, (0, 0, 0, 0, 0, pad))
                           for a in (r, k, v, lw))

        def resh(a):                            # [nch, B, H, C, K] float32
            a = a.reshape(B, nch, chunk, H, K)
            return a.permute(1, 0, 3, 2, 4).float()

        rc, kc, vc, wc = resh(r), resh(k), resh(v), resh(lw)
        mask_lt = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                        device=r.device), diagonal=-1)
        Lc = torch.cumsum(wc, dim=3)                # inclusive
        Lp = Lc - wc                                # L_{t-1}
        Dk = Lp[..., :, None, :] - Lc[..., None, :, :]   # [nch, B, H, C, C, K]
        Dk = torch.where(mask_lt[:, :, None], Dk, float("-inf"))
        A = (rc[..., :, None, :] * kc[..., None, :, :] * torch.exp(Dk)).sum(-1)
        y_intra = torch.einsum("nbhtj,nbhjv->nbhtv", A, vc)
        bonus = torch.sum(rc * (u[None, None, :, None, :] * kc), dim=-1)
        wtail = torch.exp(Lc[..., -1:, :] - Lc)
        add = torch.einsum("nbhjk,nbhjv->nbhkv", kc * wtail, vc)
        decay = torch.exp(Lc[..., -1, :])                 # [nch, B, H, K]
        entering, s = state_scan(decay.contiguous(), add.contiguous(),
                                 s0.float().contiguous())
        y_inter = torch.einsum("nbhck,nbhkv->nbhcv", rc * torch.exp(Lp),
                               entering)
        y = y_inter + y_intra + bonus[..., None] * vc
        y = y.permute(1, 0, 3, 2, 4).reshape(B, nch * chunk, H, K)
        return y[:, :S], s


def time_mix(p, x, cfg: ArchConfig, dtype, cache: RwkvCache | None):
    """Returns (out [B, S, D], the new time-mix shift, the new state).
    Split over 'model', ``p``'s static leaves are whole (:func:`block`
    gathers them)."""
    B, S, D = x.shape
    H, K = dims(cfg)
    last = cache.shift_t if cache is not None else x.new_zeros((B, D))
    xp = _shift(x, last)

    def lerp(mu):
        return x + (xp - x) * p[mu].to(dtype)

    proj = [(lerp(mu), p[w].to(dtype)) for mu, w in (
        ("mu_r", "Wr"), ("mu_k", "Wk"), ("mu_v", "Wv"), ("mu_g", "Wg"))]
    if _split(p["Wr"], D):   # row-parallel: four partials, one reduction
        r, k, v, g = L.reduce_joined(*(L.row_parallel(a, w, reduce=False)
                                       for a, w in proj))
    else:
        r, k, v, g = (a @ w for a, w in proj)
    r, k, v = (t.reshape(B, S, H, K) for t in (r, k, v))
    # the decay LoRA in float32, as the reference's promotion gives it
    xw = lerp("mu_w").float()
    lora = torch.tanh(L.row_parallel(xw, p["wA"].float()))
    wlog = p["w0"] + L.row_parallel(lora, p["wB"].float())
    # maximum against a tensor: a tie splits its gradient as jnp.maximum's
    lw = torch.maximum(-torch.exp(wlog), wlog.new_tensor(LOG_DECAY_FLOOR))
    lw = lw.reshape(B, S, H, K)

    s0 = (cache.wkv if cache is not None
          else torch.zeros((B, H, K, K), dtype=torch.float32,
                           device=x.device))
    if S == 1 and cache is not None:   # decode: the exact single step
        rr, kk, vv = (a[:, 0].float() for a in (r, k, v))
        kv = torch.einsum("bhk,bhv->bhkv", kk, vv)
        y = torch.einsum("bhk,bhkv->bhv", rr,
                         s0 + p["u"][None, :, :, None] * kv)[:, None]
        s_fin = torch.exp(lw[:, 0])[..., None] * s0 + kv
    else:
        y, s_fin = wkv_chunked(r, k, v, lw, p["u"], s0)
    y = y.reshape(B, S, D).to(dtype)
    y = L.layernorm(p["ln_x"], y, cfg.norm_eps)   # group-norm stand-in
    out = L.row_parallel(y * F.silu(g), p["Wo"].to(dtype))
    return out, x[:, -1], s_fin


def channel_mix(p, x, dtype, cache: RwkvCache | None):
    """Returns (out [B, S, D], the new channel-mix shift)."""
    B, S, D = x.shape
    last = cache.shift_c if cache is not None else x.new_zeros((B, D))
    xp = _shift(x, last)
    xk = x + (xp - x) * p["mu_ck"].to(dtype)
    xr = x + (xp - x) * p["mu_cr"].to(dtype)
    cWk, cWv, cWr = (p[n].to(dtype) for n in ("cWk", "cWv", "cWr"))
    tp = shr.active()
    f_split = tp is not None and tp.split("act_ffn")
    if f_split:
        # cWk column-parallel on F: relu^2 is local and feeds cWv's
        # row-parallel product
        xk = shr.copy_to_model(xk, tp)
    kv = torch.square(F.relu(xk @ cWk)) @ cWv
    r = L.row_parallel(xr, cWr, reduce=False)
    if f_split and _split(cWr, D):   # the two partials in one reduction
        r, kv = L.reduce_joined(r, kv)
    elif f_split:
        kv = shr.reduce_from_model(kv, tp)
    elif _split(cWr, D):
        r = shr.reduce_from_model(r, tp)
    return torch.sigmoid(r) * kv, x[:, -1]


def _split(w, D: int) -> bool:
    """True when ``w [D, ..]`` is a row-parallel block (split over 'model'
    on its input dim)."""
    return shr.active() is not None and w.shape[-2] < D


def _whole(p, cfg: ArchConfig) -> dict:
    """The block's static leaves (token shifts, decay, bonus, norms)
    whole, in one gather over 'model' when they are split."""
    D = cfg.d_model
    names = [f"{n}/{k}" for n in ("ln1", "ln2", "ln_x")
             for k in ("scale", "bias")]
    names += ["mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_ck", "mu_cr",
              "w0"]
    shapes = {n: (D,) for n in names}
    shapes["u"] = dims(cfg)
    return L.whole_leaves(p, shapes)


def block(p, x, cfg: ArchConfig, dtype, cache: RwkvCache | None = None):
    """Returns (x, the new (shift_t, shift_c, wkv) state)."""
    p = _whole(p, cfg)
    att, shift_t, wkv = time_mix(p, L.layernorm(p["ln1"], x, cfg.norm_eps),
                                 cfg, dtype, cache)
    x = x + att
    ffn, shift_c = channel_mix(p, L.layernorm(p["ln2"], x, cfg.norm_eps),
                               dtype, cache)
    return x + ffn, (shift_t, shift_c, wkv)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _block_train(blk, x, cfg: ArchConfig, dtype):
    return block(blk, x, cfg, dtype)[0]


def forward(params, tokens, *, cfg: ArchConfig, remat: bool = True):
    """[B, S] tokens -> [B, S, D] hidden states from a zero state; with
    ``remat`` each block runs under ``torch.utils.checkpoint``."""
    dtype = _dtype(cfg)
    x = L.embed(params["embed"], tokens, dtype)
    for i in range(cfg.n_layers):
        blk = TF.layer(params, i)
        if remat:
            x = checkpoint(_block_train, blk, x, cfg, dtype,
                           use_reentrant=False)
        else:
            x = _block_train(blk, x, cfg, dtype)
    return L.layernorm(params["ln_f"], x, cfg.norm_eps)


def loss(params, batch, *, cfg: ArchConfig):
    hidden = forward(params, batch["tokens"], cfg=cfg)
    return L.cross_entropy_chunked(hidden, params["embed"], batch["labels"])


# ---------------------------------------------------------------------------
# inference: the O(1) state
# ---------------------------------------------------------------------------

def init_caches(cfg: ArchConfig, batch: int, max_len: int = 0,
                n_chunks: int = 0, dtype=None, device=None) -> RwkvCache:
    """A zero state per layer, stacked: shifts ``[L, B, D]`` in the
    activation dtype, WKV ``[L, B, H, K, K]`` float32. The length and the
    chunks (and the KV cache's ``dtype``) do not apply."""
    del max_len, n_chunks, dtype
    H, K = dims(cfg)
    Lyr, D = cfg.n_layers, cfg.d_model
    act = _dtype(cfg)
    return RwkvCache(torch.zeros((Lyr, batch, D), dtype=act, device=device),
                     torch.zeros((Lyr, batch, D), dtype=act, device=device),
                     torch.zeros((Lyr, batch, H, K, K), dtype=torch.float32,
                                 device=device))


def cache_rows(caches: RwkvCache, rows: slice) -> RwkvCache:
    """Batch rows ``rows`` of every layer's state (views)."""
    return RwkvCache(*(t[:, rows] for t in caches))


def reset_cache_rows(caches: RwkvCache, rows: slice) -> RwkvCache:
    """Rows ``rows`` zeroed in place for a new request (views): a prefill
    starts from the state it is given, so a slot would otherwise carry its
    last request's state into the next."""
    view = cache_rows(caches, rows)
    for t in view:
        t.zero_()
    return view


def _run_with_cache(params, x, caches: RwkvCache, cfg: ArchConfig, dtype):
    """Every block from the state in ``caches``, which is overwritten in
    place with the new one; returns the final-normed hidden states."""
    for i in range(cfg.n_layers):
        c = RwkvCache(*(t[i] for t in caches))
        x, new = block(TF.layer(params, i), x, cfg, dtype, c)
        for dst, src in zip(c, new):
            dst.copy_(src)
    return L.layernorm(params["ln_f"], x, cfg.norm_eps)


def prefill(params, batch, caches: RwkvCache, *, cfg: ArchConfig):
    """Returns (last-token logits [B, V] float32, the caches, updated)."""
    dtype = _dtype(cfg)
    x = L.embed(params["embed"], batch["tokens"], dtype)
    hidden = _run_with_cache(params, x, caches, cfg, dtype)
    return L.unembed(params["embed"], hidden[:, -1:])[:, 0], caches


def decode_step(params, caches: RwkvCache, batch, *, cfg: ArchConfig):
    """batch: {"token": [B, 1]}. Returns (logits [B, V] float32, caches)."""
    dtype = _dtype(cfg)
    x = L.embed(params["embed"], batch["token"], dtype)
    hidden = _run_with_cache(params, x, caches, cfg, dtype)
    return L.unembed(params["embed"], hidden)[:, 0], caches


def prefill_replicas(reps, tokens, caches, *, cfg: ArchConfig):
    """Prefill ``tokens [B, S]`` on each replica against its own state.
    Returns logits ``[R, B, V]``."""
    return TF.prefill_each_replica(prefill, reps, tokens, caches, cfg)


def decode_replicas(reps, caches, tokens, *, cfg: ArchConfig):
    """The serving loop's decode: each row of ``tokens [B, 1]`` (a slot) at
    B = 1 shapes on each replica. Returns logits ``[R, B, V]``."""
    return TF.decode_each_slot(decode_step, cache_rows, reps, caches, tokens,
                               cfg)

"""Zamba2-style hybrid (PyTorch port of ``repro.models.hybrid``;
zamba2-1.2b): a Mamba2 backbone and ONE shared attention + MLP block
applied after every ``shared_attn_every`` Mamba2 layers.

The shared block's params are reused at every site (so their gradient sums
over the sites), and each site keeps its own KV cache. Training remats
each Mamba2 body only, as the reference does. The caches
(:class:`HybridCaches`: the Mamba2 states stacked ``[L, B, ...]``, the
sites' KV caches ``[n_sites, B, ...]``) are updated in place, the KV
caches with one length per batch row, so the shared block's decode
positions are per row (equal to the reference's when every row sits at
one length).

Serving (``*_replicas``) runs each replica on its own, and its decode runs
each row (a serving slot) at B = 1 shapes, so a slot's tokens equal its
own single-request run bit for bit. ``reset_cache_rows`` zeroes a slot's
Mamba2 state for a new request: the reference's prefill starts from the
state in the cache it is given, so its service carries a slot's last
request into the next (ROADMAP Queue 3).

Tensor parallelism (the 'model' axis): the Mamba2 blocks take
``mamba2.py``'s split forms, and the shared block the dense transformer's
(``layers.py``: heads and the SwiGLU hidden over 'model', under the rule
table's counts of the shared block, ``launch.steps``); its sites' KV
caches split their chunks over 'model', the Mamba2 states stay whole on
every rank.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from . import mamba2 as M
from . import transformer as TF
from .config import ArchConfig


class HybridCaches(NamedTuple):
    mamba: M.MambaCache      # leaves [L, B, ...]
    attn: L.KVCache          # leaves [n_sites, B, ...]


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.act_dtype)


def n_shared_sites(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.shared_attn_every


def _attn_dims(cfg: ArchConfig):
    heads = cfg.shared_attn_heads or cfg.n_heads
    return heads, cfg.d_model // heads


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32):
    """Random params on ``gen.device`` in ``dtype``, the reference's tree:
    ``embed``, ``mamba`` (stacked ``[L, ...]``), ``shared`` (one MHA +
    SwiGLU block) and ``ln_f``."""
    D, dev = cfg.d_model, gen.device
    heads, hd = _attn_dims(cfg)

    def ones(d):
        return {"scale": torch.ones((d,), dtype=dtype, device=dev)}

    return {"embed": L.init_embedding(gen, cfg.vocab, D, dtype),
            "mamba": M.init_mamba_blocks(gen, cfg, dtype),
            "shared": {"ln_attn": ones(D),
                       "attn": L.init_attention(gen, (), D, heads, heads, hd,
                                                dtype),
                       "ln_mlp": ones(D),
                       "mlp": L.init_swiglu(
                           gen, (), D, cfg.shared_attn_d_ff or cfg.d_ff,
                           dtype)},
            "ln_f": ones(D)}


def _segments(cfg: ArchConfig):
    """``(layers, site)`` in order: each group of ``shared_attn_every``
    Mamba2 layers followed by its shared-block site, then the remainder
    (site None)."""
    every = cfg.shared_attn_every
    n_full = n_shared_sites(cfg)
    segs = [(range(g * every, (g + 1) * every), g) for g in range(n_full)]
    if cfg.n_layers > n_full * every:
        segs.append((range(n_full * every, cfg.n_layers), None))
    return segs


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _shared_apply(p, x, rope, cfg: ArchConfig, dtype, attend):
    """The shared attention + MLP block; ``attend(q, k, v) -> attention``."""
    heads, hd = _attn_dims(cfg)
    h = L.rmsnorm(p["ln_attn"], x, cfg.norm_eps)
    q, k, v = L.attention_qkv(p["attn"], h, heads, heads, hd, None,
                              cfg.rope_theta, dtype=dtype, rope=rope)
    x = x + L.attention_out(p["attn"], attend(q, k, v), dtype)
    h = L.rmsnorm(p["ln_mlp"], x, cfg.norm_eps)
    return x + L.swiglu(p["mlp"], h, dtype)


def _causal(cfg: ArchConfig):
    def attend(q, k, v):
        q, k, v = L.attention_heads(q, k, v, _attn_dims(cfg)[0])
        return L.blocked_attention(q, k, v, causal=True, q_block=cfg.q_block,
                                   kv_block=cfg.kv_block)
    return attend


def _mamba_train(blk, x, cfg: ArchConfig, dtype):
    return M.mamba_block(blk, x, cfg, dtype)[0]


def _arange_rope(B: int, S: int, cfg: ArchConfig, device):
    positions = torch.arange(S, device=device)[None].expand(B, S)
    return L.rope_tables(positions, _attn_dims(cfg)[1], cfg.rope_theta,
                         _dtype(cfg))


def forward(params, tokens, *, cfg: ArchConfig, remat: bool = True):
    """[B, S] tokens -> [B, S, D] hidden states from a zero state; with
    ``remat`` each Mamba2 body runs under ``torch.utils.checkpoint``."""
    dtype = _dtype(cfg)
    x = L.embed(params["embed"], tokens, dtype)
    rope = _arange_rope(*tokens.shape, cfg, x.device)
    for layers, site in _segments(cfg):
        for i in layers:
            blk = TF.layer(params, i, "mamba")
            if remat:
                x = checkpoint(_mamba_train, blk, x, cfg, dtype,
                               use_reentrant=False)
            else:
                x = _mamba_train(blk, x, cfg, dtype)
        if site is not None:
            x = _shared_apply(params["shared"], x, rope, cfg, dtype,
                              _causal(cfg))
    return L.rmsnorm(params["ln_f"], x, cfg.norm_eps)


def loss(params, batch, *, cfg: ArchConfig):
    hidden = forward(params, batch["tokens"], cfg=cfg)
    return L.cross_entropy_chunked(hidden, params["embed"], batch["labels"])


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------

def init_caches(cfg: ArchConfig, batch: int, max_len: int, n_chunks: int,
                dtype=torch.bfloat16, device=None) -> HybridCaches:
    """Zero Mamba2 states ``[L, B, ...]`` (conv window in ``dtype``) and
    one KV cache per site ``[n_sites, B, ...]`` (at least one)."""
    heads, hd = _attn_dims(cfg)
    m = M.init_cache(cfg, batch, dtype, device)
    length, chunks = L.cache_extent(max_len, n_chunks)
    kv = L.KVCache.create(batch, heads, length, hd, chunks, dtype, device)
    sites = max(n_shared_sites(cfg), 1)

    def stack(t, n):
        return t.unsqueeze(0).repeat((n,) + (1,) * t.ndim)

    return HybridCaches(M.MambaCache(*(stack(t, cfg.n_layers) for t in m)),
                        L.KVCache(*(stack(t, sites) for t in kv)))


def cache_rows(caches: HybridCaches, rows: slice) -> HybridCaches:
    """Batch rows ``rows`` of every layer's and site's cache (views)."""
    return HybridCaches(M.MambaCache(*(t[:, rows] for t in caches.mamba)),
                        L.KVCache(*(t[:, rows] for t in caches.attn)))


def reset_cache_rows(caches: HybridCaches, rows: slice) -> HybridCaches:
    """Rows ``rows`` ready for a new request (views): the Mamba2 states
    zeroed in place (a prefill starts from the state it is given); a
    prefill rewrites the KV caches from position 0."""
    view = cache_rows(caches, rows)
    for t in view.mamba:
        t.zero_()
    return view


def _run_cached(params, x, caches: HybridCaches, cfg: ArchConfig, dtype,
                prefill_mode: bool):
    """Every layer and site from the states in ``caches``, which are
    overwritten in place with the new ones; returns the final-normed
    hidden states."""
    heads, hd = _attn_dims(cfg)
    B, S = x.shape[:2]
    if prefill_mode:
        rope = _arange_rope(B, S, cfg, x.device)
    else:
        # each row's position is its cache length before this token
        rope = L.rope_tables(caches.attn.length[0][:, None], hd,
                             cfg.rope_theta, dtype)
    for layers, site in _segments(cfg):
        for i in layers:
            c = M.MambaCache(*(t[i] for t in caches.mamba))
            x, new = M.mamba_block(TF.layer(params, i, "mamba"), x, cfg,
                                   dtype, c)
            for dst, src in zip(c, new):
                dst.copy_(src)
        if site is None:
            continue
        kv = L.KVCache(*(t[site] for t in caches.attn))

        def attend(q, k, v, kv=kv):
            if prefill_mode:
                L.cache_prefill(kv, *L.whole_heads((k, "act_kv_heads"),
                                                   (v, "act_kv_heads")))
                q, k, v = L.attention_heads(q, k, v, heads)
                return L.blocked_attention(q, k, v, causal=True,
                                           q_block=cfg.q_block,
                                           kv_block=cfg.kv_block)
            q, k, v = L.whole_heads((q, "act_heads"), (k, "act_kv_heads"),
                                    (v, "act_kv_heads"))
            return L.flash_decode(q, L.cache_insert(kv, k, v))

        x = _shared_apply(params["shared"], x, rope, cfg, dtype, attend)
    return L.rmsnorm(params["ln_f"], x, cfg.norm_eps)


def prefill(params, batch, caches: HybridCaches, *, cfg: ArchConfig):
    """Returns (last-token logits [B, V] float32, the caches, updated)."""
    dtype = _dtype(cfg)
    x = L.embed(params["embed"], batch["tokens"], dtype)
    hidden = _run_cached(params, x, caches, cfg, dtype, prefill_mode=True)
    return L.unembed(params["embed"], hidden[:, -1:])[:, 0], caches


def decode_step(params, caches: HybridCaches, batch, *, cfg: ArchConfig):
    """batch: {"token": [B, 1]}. Returns (logits [B, V] float32, caches)."""
    dtype = _dtype(cfg)
    x = L.embed(params["embed"], batch["token"], dtype)
    hidden = _run_cached(params, x, caches, cfg, dtype, prefill_mode=False)
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

"""Dense decoder-only transformer (PyTorch port of
``repro.models.transformer``): ``init``; the training half (``forward`` with
remat per block, ``logits_fn``, ``loss``); the inference half
(``init_caches``, ``prefill``, ``decode_step``). It serves the family
``vlm`` too (qwen2-vl-7b): ``forward``, ``loss``, ``prefill`` and
``decode_step`` take merged ``embeds`` in place of tokens and ``[3, B, S]``
M-RoPE position ids, as the reference's do.

Params keep the JAX tree and layout: ``blocks`` leaves are stacked
``[L, ...]`` and matrices are ``[in, out]``. The layer ``scan`` is a Python
loop. Serving runs several replicas (each its own params) on one batch; the
``*_replicas`` functions take a list of R param trees and run each
replica's projections on its own, at the shapes a single replica would see
(honest replicas then give bit-identical logits), while the attention
kernel takes all ``R * B * H`` rows in one launch.

Tensor parallelism (the 'model' axis): under a
:mod:`~repro_torch.models.sharding` rule table every function takes a
rank's blocks of the leaves and runs the split forms of
:mod:`~repro_torch.models.layers` — the counterparts of the reference's
``shard(x, name)`` hooks: ``act_heads`` / ``act_kv_heads`` (q and k/v
heads split where the head counts divide M, else computed whole on every
rank), ``act_btd`` (the residual stream, whole on every rank: each block
ends in a reduction over 'model'), ``logits`` (the vocab) and
``kv_cache`` (the decode cache's chunk axis; prefill and decode join the
heads of k/v and q before the cache). The logits of ``prefill`` and
``decode_step`` are then this rank's vocab block.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from .config import ArchConfig


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.act_dtype)


def _norm_fns(cfg: ArchConfig):
    """``(init(shape, dtype, device), apply(p, x))`` of the config's norm,
    as the reference's ``_norm_fns``: layernorm's ``{"scale", "bias"}`` or
    rmsnorm's ``{"scale"}``."""
    if cfg.norm == "layernorm":
        return L.init_layernorm, lambda p, x: L.layernorm(p, x,
                                                          eps=cfg.norm_eps)
    if cfg.norm != "rmsnorm":
        raise ValueError(f"norm {cfg.norm!r}: rmsnorm | layernorm")
    return L.init_rmsnorm, lambda p, x: L.rmsnorm(p, x, eps=cfg.norm_eps)


def _norm(cfg: ArchConfig):
    return _norm_fns(cfg)[1]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ArchConfig, dtype):
    """The stacked ``[L, ...]`` q/k/v/o projections of every block."""
    return L.init_attention(gen, (cfg.n_layers,), cfg.d_model, cfg.n_heads,
                            cfg.n_kv_heads, cfg.hd, dtype)


def init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32):
    """Random params on ``gen.device`` in ``dtype`` (the JAX init draws f32;
    serving casts to bf16 — passing ``dtype`` casts leaf by leaf, so the
    float32 copy of the whole model never exists)."""
    Lyr, D, Fd = cfg.n_layers, cfg.d_model, cfg.d_ff
    dev = gen.device
    init_norm = _norm_fns(cfg)[0]

    params = {
        "embed": L.init_embedding(gen, cfg.vocab, D, dtype),
        "blocks": {
            "ln_attn": init_norm((Lyr, D), dtype, dev),
            "attn": init_attention(gen, cfg, dtype),
            "ln_mlp": init_norm((Lyr, D), dtype, dev),
            "mlp": L.init_swiglu(gen, (Lyr,), D, Fd, dtype),
        },
        "ln_f": init_norm(D, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": L.init_dense(gen, D, (cfg.vocab, D),
                                                   dtype)}
    return params


def layer(params, i: int, stack: str = "blocks"):
    """Block ``i``'s params (views into the stacked ``[L, ...]`` leaves of
    ``params[stack]``)."""
    def walk(t):
        return {k: walk(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return walk(params[stack])


# ---------------------------------------------------------------------------
# training: forward with remat, logits, loss
# ---------------------------------------------------------------------------

def swiglu_ffn(blk, h, cfg: ArchConfig, dtype):
    """The dense block's FFN; a family with another FFN (the MoE) passes
    its own as ``ffn`` to the functions below."""
    return L.swiglu(blk["mlp"], h, dtype)


def _block_train(blk, x, rope, cfg: ArchConfig, dtype, ffn=swiglu_ffn):
    norm = _norm(cfg)
    q, k, v = L.attention_qkv(blk["attn"], norm(blk["ln_attn"], x),
                              cfg.n_heads, cfg.n_kv_heads, cfg.hd, None,
                              cfg.rope_theta, dtype=dtype, rope=rope)
    q, k, v = L.attention_heads(q, k, v, cfg.n_heads)
    attn = L.blocked_attention(q, k, v, causal=True,
                               window=cfg.sliding_window, q_block=cfg.q_block,
                               kv_block=cfg.kv_block)
    x = x + L.attention_out(blk["attn"], attn, dtype)
    return x + ffn(blk, norm(blk["ln_mlp"], x), cfg, dtype)


def forward(params, tokens=None, *, cfg: ArchConfig, embeds=None,
            positions=None, remat: bool = True, ffn=swiglu_ffn):
    """[B, S] tokens (or [B, S, D] embeds) -> [B, S, D] hidden states.

    The JAX layer ``scan`` is a loop over the stacked blocks; with ``remat``
    each block runs under ``torch.utils.checkpoint`` (``use_reentrant=
    False``), so only its input is kept and its activations are recomputed
    in the backward, as ``jax.checkpoint`` on the block body does."""
    dtype = _dtype(cfg)
    x = (L.embed(params["embed"], tokens, dtype) if embeds is None
         else embeds.to(dtype))
    B, S = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    rope = L.rope_tables(positions, cfg.hd, cfg.rope_theta, dtype)
    for i in range(cfg.n_layers):
        blk = layer(params, i)
        if remat:
            x = checkpoint(_block_train, blk, x, rope, cfg, dtype, ffn,
                           use_reentrant=False)
        else:
            x = _block_train(blk, x, rope, cfg, dtype, ffn)
    return _norm(cfg)(params["ln_f"], x)


def logits_fn(params, hidden, cfg: ArchConfig):
    """[B, S, D] hidden -> [B, S, V] float32 logits."""
    return _logits(params, hidden, cfg)


def loss(params, batch, *, cfg: ArchConfig, ffn=swiglu_ffn):
    """Mean next-token NLL of ``batch`` (``tokens``, ``labels`` [B, S]),
    the logits streamed by sequence chunks."""
    hidden = forward(params, batch.get("tokens"), cfg=cfg,
                     embeds=batch.get("embeds"),
                     positions=batch.get("positions"), ffn=ffn)
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return L.cross_entropy_chunked(hidden, table, batch["labels"])


# ---------------------------------------------------------------------------
# inference: prefill + decode
# ---------------------------------------------------------------------------

def init_caches(cfg: ArchConfig, batch: int, max_len: int, n_chunks: int,
                dtype=torch.bfloat16, device=None) -> L.KVCache:
    """One cache per layer, stacked: k/v ``[L, B, kvH, nc, ck, hd]``,
    length ``[L, B]``; under a rule table that splits ``kv_cache`` over
    'model', this rank's ``nc / M`` chunks."""
    length, chunks = L.cache_extent(max_len, n_chunks)
    c = L.KVCache.create(batch, cfg.n_kv_heads, length, cfg.hd, chunks,
                         dtype, device)
    return L.KVCache(*(t.unsqueeze(0).repeat((cfg.n_layers,)
                                             + (1,) * t.ndim) for t in c))


def cache_layer(caches: L.KVCache, i: int) -> L.KVCache:
    """Layer ``i``'s cache (views: in-place writes land in the stack)."""
    return L.KVCache(caches.k[i], caches.v[i], caches.length[i])


def cache_rows(caches: L.KVCache, rows: slice) -> L.KVCache:
    """Batch rows ``rows`` of every layer's cache (views), e.g. one serving
    slot to prefill."""
    return L.KVCache(caches.k[:, rows], caches.v[:, rows],
                     caches.length[:, rows])


def reset_cache_rows(caches: L.KVCache, rows: slice) -> L.KVCache:
    """Rows ``rows`` ready for a new request: a prefill rewrites a KV
    cache from position 0, so nothing is cleared (views)."""
    return cache_rows(caches, rows)


def prefill_each_replica(prefill_fn, reps, tokens, caches,
                         cfg: ArchConfig):
    """A state-carrying family's serving prefill: ``prefill_fn`` (its
    ``prefill``) on each replica against its own caches. Returns logits
    ``[R, B, V]``."""
    return torch.stack([prefill_fn(p, {"tokens": tokens}, c, cfg=cfg)[0]
                        for p, c in zip(reps, caches)])


def decode_each_slot(decode_fn, rows_fn, reps, caches, tokens,
                     cfg: ArchConfig):
    """A state-carrying family's serving decode: each row of ``tokens [B,
    1]`` (a slot) through ``decode_fn`` (its ``decode_step``) at B = 1
    shapes on each replica, the slot's caches taken by ``rows_fn`` (its
    ``cache_rows``), so a slot's tokens equal its own single-request run
    bit for bit. Returns logits ``[R, B, V]``."""
    return torch.cat([
        torch.stack([decode_fn(p, rows_fn(c, slice(b, b + 1)),
                               {"token": tokens[b:b + 1]}, cfg=cfg)[0]
                     for p, c in zip(reps, caches)])
        for b in range(tokens.shape[0])], dim=1)


def _logits(params, hidden, cfg: ArchConfig):
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return L.unembed(table, hidden)


def _attention_mlp(xs, blocks, rope, cfg, dtype, attend, ffn):
    """One block on every replica: per-replica norm and projections (RoPE
    from the precomputed ``rope`` tables), ``attend(qs, ks, vs) ->
    per-replica attention outputs``, then per-replica output projection and
    ``ffn``."""
    norm = _norm(cfg)
    qkv = [L.attention_qkv(blk["attn"], norm(blk["ln_attn"], x), cfg.n_heads,
                           cfg.n_kv_heads, cfg.hd, None, cfg.rope_theta,
                           dtype=dtype, rope=rope)
           for blk, x in zip(blocks, xs)]
    attn = attend(*zip(*qkv))
    out = []
    for blk, x, a in zip(blocks, xs, attn):
        x = x + L.attention_out(blk["attn"], a, dtype)
        out.append(x + ffn(blk, norm(blk["ln_mlp"], x), cfg, dtype))
    return out


def _prefill(reps, xs, rope, caches, cfg: ArchConfig, ffn):
    """Every block over the replicas' inputs ``xs`` ([B, S, D] each),
    filling their caches in place; the attention takes every replica's
    rows in one launch. Returns last-token logits ``[R, B, V]``."""
    dtype = _dtype(cfg)
    R = len(reps)
    for i in range(cfg.n_layers):
        blocks = [layer(p, i) for p in reps]

        def attend(qs, ks, vs, i=i):
            for c, k, v in zip(caches, ks, vs):
                L.cache_prefill(cache_layer(c, i), *L.whole_heads(
                    (k, "act_kv_heads"), (v, "act_kv_heads")))
            q, k, v = L.attention_heads(torch.cat(qs), torch.cat(ks),
                                        torch.cat(vs), cfg.n_heads)
            o = L.blocked_attention(q, k, v, causal=True,
                                    window=cfg.sliding_window,
                                    q_block=cfg.q_block,
                                    kv_block=cfg.kv_block)
            return o.chunk(R)

        xs = _attention_mlp(xs, blocks, rope, cfg, dtype, attend, ffn)
    norm = _norm(cfg)
    return torch.stack([_logits(p, norm(p["ln_f"], x[:, -1:]), cfg)[:, 0]
                        for p, x in zip(reps, xs)])


def _decode(reps, xs, rope, caches, cfg: ArchConfig, ffn):
    """One position ``xs`` ([B, 1, D] each) against each replica's caches,
    updated in place. Returns logits ``[R, B, V]``."""
    dtype = _dtype(cfg)
    for i in range(cfg.n_layers):
        blocks = [layer(p, i) for p in reps]

        def attend(qs, ks, vs, i=i):
            out = []
            for c, q, k, v in zip(caches, qs, ks, vs):
                q, k, v = L.whole_heads((q, "act_heads"),
                                        (k, "act_kv_heads"),
                                        (v, "act_kv_heads"))
                cache = L.cache_insert(cache_layer(c, i), k, v)
                out.append(L.flash_decode(q, cache,
                                          window=cfg.sliding_window))
            return out

        xs = _attention_mlp(xs, blocks, rope, cfg, dtype, attend, ffn)
    norm = _norm(cfg)
    return torch.stack([_logits(p, norm(p["ln_f"], x), cfg)[:, 0]
                        for p, x in zip(reps, xs)])


def prefill_replicas(reps, tokens, caches, *, cfg: ArchConfig,
                     ffn=swiglu_ffn):
    """Prefill ``tokens [B, S]`` on R replicas. ``reps``: list of R param
    trees; ``caches``: list of R stacked caches, filled in place. Returns
    last-token logits ``[R, B, V]`` float32."""
    dtype = _dtype(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    rope = L.rope_tables(positions, cfg.hd, cfg.rope_theta, dtype)
    xs = [L.embed(p["embed"], tokens, dtype) for p in reps]
    return _prefill(reps, xs, rope, caches, cfg, ffn)


def decode_replicas(reps, caches, tokens, *, cfg: ArchConfig,
                    ffn=swiglu_ffn):
    """One token ``[B, 1]`` per row against each replica's caches (each row
    at its own position, its cache length). Returns logits ``[R, B, V]``
    float32; caches are updated in place."""
    dtype = _dtype(cfg)
    xs = [L.embed(p["embed"], tokens, dtype) for p in reps]
    # each row's position is its cache length before this token's insert
    positions = caches[0].length[0][:, None]              # [B, 1]
    rope = L.rope_tables(positions, cfg.hd, cfg.rope_theta, dtype)
    return _decode(reps, xs, rope, caches, cfg, ffn)


def _inputs(params, batch, key: str, cfg: ArchConfig):
    """The activations of ``batch``: its ``embeds`` (the vlm family's
    merged patch and text embeddings) or its token ids under ``key``."""
    dtype = _dtype(cfg)
    embeds = batch.get("embeds")
    if embeds is None:
        return L.embed(params["embed"], batch[key], dtype)
    return embeds.to(dtype)


def prefill(params, batch, caches, *, cfg: ArchConfig):
    """batch: {"tokens": [B, S]} or {"embeds": [B, S, D]}, optional
    "positions" ([B, S], or [3, B, S] for M-RoPE; default 0 .. S-1).
    Returns (last-token logits [B, V] float32, filled caches)."""
    x = _inputs(params, batch, "tokens", cfg)
    B, S = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    rope = L.rope_tables(positions, cfg.hd, cfg.rope_theta, _dtype(cfg))
    return _prefill([params], [x], rope, [caches], cfg, swiglu_ffn)[0], caches


def decode_step(params, caches, batch, *, cfg: ArchConfig):
    """batch: {"token": [B, 1]} or {"embeds": [B, 1, D]}, optional
    "positions" ([B, 1] or [3, B, 1]; default each row's cache length).
    Returns (logits [B, V] float32, caches). One new position against the
    KV cache."""
    x = _inputs(params, batch, "token", cfg)
    positions = batch.get("positions")
    if positions is None:
        positions = caches.length[0][:, None]
    rope = L.rope_tables(positions, cfg.hd, cfg.rope_theta, _dtype(cfg))
    return _decode([params], [x], rope, [caches], cfg, swiglu_ffn)[0], caches

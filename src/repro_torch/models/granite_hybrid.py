"""Granite 4.0-H (``model_type`` ``granitemoehybrid`` without experts;
granite-4.0-h-micro): one stack of layers, each a Mamba2 mixer or a GQA
attention mixer as ``cfg.layer_types`` names it, then a SwiGLU MLP, with
the muP multipliers of :class:`~repro_torch.models.config.
HybridStackConfig`:

    x = embedding_multiplier * embed(tokens)
    per layer:  x = x + residual_multiplier * mixer(rmsnorm(x))
                x = x + residual_multiplier * swiglu(rmsnorm(x))
    logits = rmsnorm(x) @ embed^T / logits_scaling

The Mamba2 mixer is :func:`repro_torch.models.mamba2.mamba_mixer`
(``BambaMixer.torch_forward``'s equations, with the port's log-decay
floor); attention has no positional embedding and the softmax scale
``attention_multiplier``. Leaves: ``embed``, ``mamba`` (the Mamba2 layers
stacked ``[Lm, ...]``), ``attn`` (the attention layers ``[La, ...]``),
``mlp``, ``ln_mix`` and ``ln_mlp`` (every layer ``[L, ...]``), ``ln_f``; a
stack with no layer at the configured depth is left out.

Training remats each layer. The caches (:class:`StackCaches`: the Mamba2
states ``[Lm, B, ...]``, the attention layers' KV caches ``[La, B,
...]``) are updated in place, the KV caches with one length per row.
Serving runs each replica on its own and decodes each row (a slot) at B =
1 shapes, as the hybrid family does. The family takes no 'model' axis
(:data:`repro_torch.models.registry.MODEL_AXIS_FAMILIES`).

The mixer is called as ``M.mamba_mixer``, a module attribute, so that a
profiler range can wrap it.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from . import mamba2 as M
from . import transformer as TF
from .config import HybridStackConfig


class StackCaches(NamedTuple):
    mamba: M.MambaCache      # leaves [Lm, B, ...]
    attn: L.KVCache          # leaves [La, B, ...]


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.act_dtype)


def slots(cfg: HybridStackConfig) -> list[tuple[str, int]]:
    """``(kind, index in its stack)`` of each layer: ``"mamba"`` or
    ``"attention"``."""
    kinds = tuple(cfg.layer_types[:cfg.n_layers])
    if len(kinds) != cfg.n_layers or set(kinds) - {"mamba", "attention"}:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} needs as many "
                         f"layer_types of 'mamba' / 'attention'; got {kinds}")
    seen = {"mamba": 0, "attention": 0}
    out = []
    for k in kinds:
        out.append((k, seen[k]))
        seen[k] += 1
    return out


def _counts(cfg) -> tuple[int, int]:
    kinds = [k for k, _ in slots(cfg)]
    return kinds.count("mamba"), kinds.count("attention")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init(gen: torch.Generator, cfg: HybridStackConfig, dtype=torch.float32):
    """Random params on ``gen.device`` in ``dtype`` (the module's tree):
    the Mamba2 mixers by :func:`repro_torch.models.mamba2.
    init_mamba_blocks`' laws (without its block norm), the rest by
    :mod:`layers`'."""
    D, Lyr, dev = cfg.d_model, cfg.n_layers, gen.device
    n_m, n_a = _counts(cfg)
    out = {"embed": L.init_embedding(gen, cfg.vocab, D, dtype)}
    if n_m:
        out["mamba"] = M.init_mamba_blocks(
            gen, dataclasses.replace(cfg, n_layers=n_m), dtype)
        del out["mamba"]["ln"]
    if n_a:
        out["attn"] = L.init_attention(gen, (n_a,), D, cfg.n_heads,
                                       cfg.n_kv_heads, cfg.hd, dtype)
    out["mlp"] = L.init_swiglu(gen, (Lyr,), D, cfg.d_ff, dtype)
    for name in ("ln_mix", "ln_mlp"):
        out[name] = L.init_rmsnorm((Lyr, D), dtype, dev)
    out["ln_f"] = L.init_rmsnorm((D,), dtype, dev)
    return out


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------

def _block(params, i: int, kind: str, j: int) -> dict:
    """Layer ``i``'s params (views): its norms and MLP, and its mixer, the
    ``j``-th of its stack."""
    stack = "mamba" if kind == "mamba" else "attn"
    return {"ln_mix": {"scale": params["ln_mix"]["scale"][i]},
            "ln_mlp": {"scale": params["ln_mlp"]["scale"][i]},
            "mlp": TF.layer(params, i, "mlp"),
            "mixer": TF.layer(params, j, stack)}


def _sublayers(blk, x, cfg, dtype, mix):
    """The mixer's and the MLP's residual branches, each scaled by
    ``residual_multiplier``; ``mix(h)`` is the mixer on the normed x."""
    r, eps = cfg.residual_multiplier, cfg.norm_eps
    x = x + r * mix(L.rmsnorm(blk["ln_mix"], x, eps))
    return x + r * L.swiglu(blk["mlp"], L.rmsnorm(blk["ln_mlp"], x, eps),
                            dtype)


def _qkv(p, h, cfg, dtype):
    """q, k, v with no positional embedding."""
    return L.attention_qkv(p, h, cfg.n_heads, cfg.n_kv_heads, cfg.hd, None,
                           cfg.rope_theta, dtype=dtype)


def _train_layer(blk, x, kind: str, cfg, dtype):
    if kind == "mamba":
        def mix(h):
            return M.mamba_mixer(blk["mixer"], h, cfg, dtype)[0]
    else:
        def mix(h):
            q, k, v = _qkv(blk["mixer"], h, cfg, dtype)
            o = L.blocked_attention(q, k, v, causal=True, q_block=cfg.q_block,
                                    kv_block=cfg.kv_block,
                                    scale=cfg.attention_multiplier)
            return L.attention_out(blk["mixer"], o, dtype)
    return _sublayers(blk, x, cfg, dtype, mix)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _embed(params, tokens, cfg, dtype):
    return L.embed(params["embed"], tokens, dtype) * cfg.embedding_multiplier


def _head_in(hidden, cfg):
    """The final hidden states over ``logits_scaling`` (exact for a power
    of two), so the tied head's product gives the scaled logits."""
    return hidden * (1.0 / cfg.logits_scaling)


def forward(params, tokens, *, cfg: HybridStackConfig, remat: bool = True):
    """[B, S] tokens -> [B, S, D] final-normed hidden states from a zero
    state; with ``remat`` each layer runs under
    ``torch.utils.checkpoint``."""
    dtype = _dtype(cfg)
    x = _embed(params, tokens, cfg, dtype)
    for i, (kind, j) in enumerate(slots(cfg)):
        blk = _block(params, i, kind, j)
        if remat:
            x = checkpoint(_train_layer, blk, x, kind, cfg, dtype,
                           use_reentrant=False)
        else:
            x = _train_layer(blk, x, kind, cfg, dtype)
    return L.rmsnorm(params["ln_f"], x, cfg.norm_eps)


def loss(params, batch, *, cfg: HybridStackConfig):
    hidden = forward(params, batch["tokens"], cfg=cfg)
    return L.cross_entropy_chunked(_head_in(hidden, cfg), params["embed"],
                                   batch["labels"])


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------

def init_caches(cfg: HybridStackConfig, batch: int, max_len: int,
                n_chunks: int, dtype=torch.bfloat16,
                device=None) -> StackCaches:
    """Zero Mamba2 states ``[Lm, B, ...]`` (conv window in ``dtype``) and
    one KV cache per attention layer ``[La, B, ...]``."""
    n_m, n_a = _counts(cfg)
    m = M.init_cache(cfg, batch, dtype, device)
    length, chunks = L.cache_extent(max_len, n_chunks)
    kv = L.KVCache.create(batch, cfg.n_kv_heads, length, cfg.hd, chunks,
                          dtype, device)

    def stack(t, n):
        return t.unsqueeze(0).repeat((n,) + (1,) * t.ndim)

    return StackCaches(M.MambaCache(*(stack(t, n_m) for t in m)),
                       L.KVCache(*(stack(t, n_a) for t in kv)))


def cache_rows(caches: StackCaches, rows: slice) -> StackCaches:
    """Batch rows ``rows`` of every layer's cache (views)."""
    return StackCaches(M.MambaCache(*(t[:, rows] for t in caches.mamba)),
                       L.KVCache(*(t[:, rows] for t in caches.attn)))


def reset_cache_rows(caches: StackCaches, rows: slice) -> StackCaches:
    """Rows ``rows`` ready for a new request (views): the Mamba2 states
    zeroed in place (a prefill starts from the state it is given); a
    prefill rewrites the KV caches from position 0."""
    view = cache_rows(caches, rows)
    for t in view.mamba:
        t.zero_()
    return view


def _run_cached(params, x, caches: StackCaches, cfg, dtype,
                prefill_mode: bool):
    """Every layer from the states in ``caches``, which are overwritten in
    place with the new ones; returns the final-normed hidden states."""
    for i, (kind, j) in enumerate(slots(cfg)):
        blk = _block(params, i, kind, j)
        if kind == "mamba":
            c = M.MambaCache(*(t[j] for t in caches.mamba))

            def mix(h, blk=blk, c=c):
                out, new = M.mamba_mixer(blk["mixer"], h, cfg, dtype, c)
                for dst, src in zip(c, new):
                    dst.copy_(src)
                return out
        else:
            kv = L.KVCache(*(t[j] for t in caches.attn))

            def mix(h, blk=blk, kv=kv):
                q, k, v = _qkv(blk["mixer"], h, cfg, dtype)
                if prefill_mode:
                    L.cache_prefill(kv, k, v)
                    o = L.blocked_attention(q, k, v, causal=True,
                                            q_block=cfg.q_block,
                                            kv_block=cfg.kv_block,
                                            scale=cfg.attention_multiplier)
                else:
                    o = L.flash_decode(q, L.cache_insert(kv, k, v),
                                       scale=cfg.attention_multiplier)
                return L.attention_out(blk["mixer"], o, dtype)
        x = _sublayers(blk, x, cfg, dtype, mix)
    return L.rmsnorm(params["ln_f"], x, cfg.norm_eps)


def prefill(params, batch, caches: StackCaches, *, cfg: HybridStackConfig):
    """Returns (last-token logits [B, V] float32, the caches, updated)."""
    dtype = _dtype(cfg)
    x = _embed(params, batch["tokens"], cfg, dtype)
    hidden = _run_cached(params, x, caches, cfg, dtype, prefill_mode=True)
    return L.unembed(params["embed"],
                     _head_in(hidden[:, -1:], cfg))[:, 0], caches


def decode_step(params, caches: StackCaches, batch, *,
                cfg: HybridStackConfig):
    """batch: {"token": [B, 1]}. Returns (logits [B, V] float32, caches)."""
    dtype = _dtype(cfg)
    x = _embed(params, batch["token"], cfg, dtype)
    hidden = _run_cached(params, x, caches, cfg, dtype, prefill_mode=False)
    return L.unembed(params["embed"], _head_in(hidden, cfg))[:, 0], caches


def prefill_replicas(reps, tokens, caches, *, cfg: HybridStackConfig):
    """Prefill ``tokens [B, S]`` on each replica against its own state.
    Returns logits ``[R, B, V]``."""
    return TF.prefill_each_replica(prefill, reps, tokens, caches, cfg)


def decode_replicas(reps, caches, tokens, *, cfg: HybridStackConfig):
    """The serving loop's decode: each row of ``tokens [B, 1]`` (a slot) at
    B = 1 shapes on each replica. Returns logits ``[R, B, V]``."""
    return TF.decode_each_slot(decode_step, cache_rows, reps, caches, tokens,
                               cfg)

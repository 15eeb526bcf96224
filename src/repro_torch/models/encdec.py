"""Whisper-style encoder-decoder (PyTorch port of ``repro.models.encdec``;
whisper-small, the audio family).

The conv / mel frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings ``enc_frames [B, S_enc, D]``. Sinusoidal
positions on the encoder, learned positions (``pos_dec``, 65,536 rows) on
the decoder, pre-LN layernorm, GELU MLPs, MHA, tied decoder embedding.
The encoder's self-attention and the decoder's cross-attention are
non-causal.

Serving: ``prefill`` encodes the frames, fills the decoder's self-attention
caches and returns each layer's cross K/V over exactly the frames' ``Se``
(the ``max_source_len`` allocation of ``init_caches`` is replaced, as the
reference's is); ``decode_step`` then runs decoder steps against them. The
self-attention cache keeps one length per batch row, so each row's learned
position is gathered at its own length (the reference slices one position
for the batch; the two agree when every row sits at one length).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from .config import ArchConfig
from .transformer import layer

MAX_DEC_POSITIONS = 65536   # the learned decoder position table's rows


class EncDecCaches(NamedTuple):
    self_kv: L.KVCache       # leaves [L, B, ...]
    cross_k: torch.Tensor    # [L, B, Se, H, hd]
    cross_v: torch.Tensor


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.act_dtype)


def sinusoids(length: int, d: int, device=None) -> torch.Tensor:
    """``[length, d]`` sin / cos positions, computed in float64 numpy and
    rounded once to float32, as the reference's."""
    lt = np.log(10000.0) / (d // 2 - 1)
    inv = np.exp(-lt * np.arange(d // 2))
    ang = np.arange(length)[:, None] * inv[None, :]
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=1)
    return torch.from_numpy(table.astype(np.float32)).to(device)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32):
    """Random params on ``gen.device`` in ``dtype``, the reference's tree:
    ``embed``, ``pos_dec`` (``0.01 * normal``), ``enc_blocks`` and
    ``dec_blocks`` (stacked ``[L, ...]``), ``ln_enc``, ``ln_f``."""
    D, H, hd, Fd, dev = (cfg.d_model, cfg.n_heads, cfg.hd, cfg.d_ff,
                         gen.device)
    Le, Ld = (cfg.encoder_layers,), (cfg.n_layers,)

    def ln(lead=()):
        return L.init_layernorm(lead + (D,), dtype, dev)

    attn = partial(L.init_attention, gen, d_model=D, n_heads=H,
                   n_kv_heads=H, head_dim=hd, dtype=dtype)
    return {
        "embed": L.init_embedding(gen, cfg.vocab, D, dtype),
        "pos_dec": (0.01 * torch.randn((MAX_DEC_POSITIONS, D), generator=gen,
                                       device=dev)).to(dtype),
        "enc_blocks": {"ln_attn": ln(Le), "attn": attn(Le), "ln_mlp": ln(Le),
                       "mlp": L.init_gelu_mlp(gen, Le, D, Fd, dtype)},
        "dec_blocks": {"ln_self": ln(Ld), "self_attn": attn(Ld),
                       "ln_cross": ln(Ld), "cross_attn": attn(Ld),
                       "ln_mlp": ln(Ld),
                       "mlp": L.init_gelu_mlp(gen, Ld, D, Fd, dtype)},
        "ln_enc": ln(), "ln_f": ln()}


# ---------------------------------------------------------------------------
# encoder, decoder
# ---------------------------------------------------------------------------

def _qkv(p, h, cfg: ArchConfig, dtype):
    return L.attention_qkv(p, h, cfg.n_heads, cfg.n_heads, cfg.hd, None,
                           cfg.rope_theta, dtype=dtype)


def _enc_block(blk, x, cfg: ArchConfig, dtype):
    h = L.layernorm(blk["ln_attn"], x, cfg.norm_eps)
    q, k, v = _qkv(blk["attn"], h, cfg, dtype)
    attn = L.blocked_attention(q, k, v, causal=False, cross=True,
                               q_block=cfg.q_block, kv_block=cfg.kv_block)
    x = x + L.attention_out(blk["attn"], attn, dtype)
    h = L.layernorm(blk["ln_mlp"], x, cfg.norm_eps)
    return x + L.gelu_mlp(blk["mlp"], h, dtype)


def encode(params, frames, *, cfg: ArchConfig, remat: bool = True):
    """frames: [B, S_enc, D] stub embeddings -> [B, S_enc, D]; with
    ``remat`` each block runs under ``torch.utils.checkpoint``."""
    dtype = _dtype(cfg)
    S = frames.shape[1]
    x = frames.to(dtype) + sinusoids(S, cfg.d_model, frames.device).to(dtype)
    for i in range(cfg.encoder_layers):
        blk = layer(params, i, "enc_blocks")
        if remat:
            x = checkpoint(_enc_block, blk, x, cfg, dtype,
                           use_reentrant=False)
        else:
            x = _enc_block(blk, x, cfg, dtype)
    return L.layernorm(params["ln_enc"], x, cfg.norm_eps)


def _cross_kv(p, enc_out, cfg: ArchConfig, dtype):
    """The cross-attention's K and V ``[B, Se, H, hd]`` from the encoder's
    output."""
    B, Se, _ = enc_out.shape
    shape = (B, Se, cfg.n_heads, cfg.hd)
    return ((enc_out @ p["wk"].to(dtype)).reshape(shape),
            (enc_out @ p["wv"].to(dtype)).reshape(shape))


def _dec_block(blk, x, cfg: ArchConfig, dtype, self_attend, kc, vc,
               q_block: int):
    """One decoder block: self-attention through ``self_attend(q, k, v)``,
    non-causal cross-attention against ``kc``/``vc``, the GELU MLP."""
    h = L.layernorm(blk["ln_self"], x, cfg.norm_eps)
    q, k, v = _qkv(blk["self_attn"], h, cfg, dtype)
    x = x + L.attention_out(blk["self_attn"], self_attend(q, k, v), dtype)
    h = L.layernorm(blk["ln_cross"], x, cfg.norm_eps)
    qc = _qkv(blk["cross_attn"], h, cfg, dtype)[0]
    cattn = L.blocked_attention(qc, kc, vc, causal=False, cross=True,
                                q_block=q_block, kv_block=cfg.kv_block)
    x = x + L.attention_out(blk["cross_attn"], cattn, dtype)
    h = L.layernorm(blk["ln_mlp"], x, cfg.norm_eps)
    return x + L.gelu_mlp(blk["mlp"], h, dtype)


def _dec_block_train(blk, x, enc_out, cfg: ArchConfig, dtype):
    def causal(q, k, v):
        return L.blocked_attention(q, k, v, causal=True, q_block=cfg.q_block,
                                   kv_block=cfg.kv_block)
    kc, vc = _cross_kv(blk["cross_attn"], enc_out, cfg, dtype)
    return _dec_block(blk, x, cfg, dtype, causal, kc, vc, cfg.q_block)


def _dec_inputs(params, tokens, dtype, rows=None):
    """Token embeddings plus the learned positions: 0 .. S-1, or with
    ``rows`` ([B] positions) each row's own, clamped to the table as the
    reference's dynamic slice."""
    if rows is None:
        pos = params["pos_dec"][:tokens.shape[1]]
    else:
        rows = rows.clamp(max=MAX_DEC_POSITIONS - 1)
        pos = params["pos_dec"][rows][:, None]
    return L.embed(params["embed"], tokens, dtype) + pos.to(dtype)


def decode_train(params, tokens, enc_out, *, cfg: ArchConfig,
                 remat: bool = True):
    dtype = _dtype(cfg)
    x = _dec_inputs(params, tokens, dtype)
    for i in range(cfg.n_layers):
        blk = layer(params, i, "dec_blocks")
        if remat:
            x = checkpoint(_dec_block_train, blk, x, enc_out, cfg, dtype,
                           use_reentrant=False)
        else:
            x = _dec_block_train(blk, x, enc_out, cfg, dtype)
    return L.layernorm(params["ln_f"], x, cfg.norm_eps)


def loss(params, batch, *, cfg: ArchConfig):
    enc_out = encode(params, batch["enc_frames"], cfg=cfg)
    hidden = decode_train(params, batch["tokens"], enc_out, cfg=cfg)
    return L.cross_entropy_chunked(hidden, params["embed"], batch["labels"])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_caches(cfg: ArchConfig, batch: int, max_len: int, n_chunks: int,
                dtype=torch.bfloat16, device=None) -> EncDecCaches:
    """Per-layer self-attention caches and cross K/V allocated at
    ``max_source_len`` frames (``prefill`` replaces them)."""
    Ld = cfg.n_layers
    kv = L.KVCache.create(batch, cfg.n_heads, max_len, cfg.hd, n_chunks,
                          dtype, device)
    kv = L.KVCache(*(t.unsqueeze(0).repeat((Ld,) + (1,) * t.ndim)
                     for t in kv))
    z = torch.zeros((Ld, batch, cfg.max_source_len, cfg.n_heads, cfg.hd),
                    dtype=dtype, device=device)
    return EncDecCaches(kv, z, z)


def prefill(params, batch, caches: EncDecCaches, *, cfg: ArchConfig):
    """Encodes ``batch["enc_frames"]``, fills the decoder's self-attention
    caches with ``batch["tokens"]`` (in place) and computes each layer's
    cross K/V over the frames. Returns (last-token logits [B, V] float32,
    caches with those cross K/V)."""
    dtype = _dtype(cfg)
    enc_out = encode(params, batch["enc_frames"], cfg=cfg, remat=False)
    tokens = batch["tokens"]
    x = _dec_inputs(params, tokens, dtype)
    cks, cvs = [], []
    for i in range(cfg.n_layers):
        blk = layer(params, i, "dec_blocks")
        kv = L.KVCache(*(t[i] for t in caches.self_kv))

        def causal(q, k, v, kv=kv):
            L.cache_prefill(kv, k, v)
            return L.blocked_attention(q, k, v, causal=True,
                                       q_block=cfg.q_block,
                                       kv_block=cfg.kv_block)

        kc, vc = _cross_kv(blk["cross_attn"], enc_out, cfg, dtype)
        x = _dec_block(blk, x, cfg, dtype, causal, kc, vc, cfg.q_block)
        cks.append(kc)
        cvs.append(vc)
    hidden = L.layernorm(params["ln_f"], x[:, -1:], cfg.norm_eps)
    logits = L.unembed(params["embed"], hidden)[:, 0]
    return logits, EncDecCaches(caches.self_kv, torch.stack(cks),
                                torch.stack(cvs))


def decode_step(params, caches: EncDecCaches, batch, *, cfg: ArchConfig):
    """batch: {"token": [B, 1]}. One decoder step at each row's position
    (its cache length) against the self-attention caches (updated in place)
    and the fixed cross K/V (a one-row query over the ``Se`` frames).
    Returns (logits [B, V] float32, caches)."""
    dtype = _dtype(cfg)
    tok = batch["token"]
    x = _dec_inputs(params, tok, dtype, rows=caches.self_kv.length[0])
    for i in range(cfg.n_layers):
        blk = layer(params, i, "dec_blocks")
        kv = L.KVCache(*(t[i] for t in caches.self_kv))

        def cached(q, k, v, kv=kv):
            return L.flash_decode(q, L.cache_insert(kv, k, v))

        x = _dec_block(blk, x, cfg, dtype, cached, caches.cross_k[i],
                       caches.cross_v[i], 1)
    hidden = L.layernorm(params["ln_f"], x, cfg.norm_eps)
    return L.unembed(params["embed"], hidden)[:, 0], caches

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

Tensor parallelism (the 'model' axis): the encoder's and decoder's
attention take the dense transformer's head layouts (``layers.py``), the
cross-attention its q from the decoder and its K/V (this rank's heads)
from the whole encoder output; in the GELU MLP ``w_up`` is
column-parallel with this rank's block of ``b_up`` and ``w_down``
row-parallel with ``b_down`` added once, after the reduction;
``pos_dec``'s rows are split over 'model' and read by lookup (a rank's
rows, zeros elsewhere, summed). The self-attention caches split their
chunks over 'model'; the cross K/V hold this rank's heads.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from . import sharding as shr
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


def _cross_q(p, h, cfg: ArchConfig, dtype):
    """The cross-attention's q ``[B, S, H', hd]`` (this rank's heads, or
    every head, as ``attention_qkv``'s q)."""
    tp = shr.active()
    w = p["wq"].to(dtype)
    if tp is not None and tp.split("act_heads"):
        q = shr.copy_to_model(h, tp) @ w
    else:
        q = L.row_parallel(h, w)
    return q.reshape(h.shape[0], h.shape[1], -1, cfg.hd)


def _enc_block(blk, x, cfg: ArchConfig, dtype):
    h = L.layernorm(blk["ln_attn"], x, cfg.norm_eps)
    q, k, v = _qkv(blk["attn"], h, cfg, dtype)
    q, k, v = L.attention_heads(q, k, v, cfg.n_heads)
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
    tp = shr.active()
    if tp is not None and tp.split("act_kv_heads"):
        # column-parallel: this rank's heads of the whole frames
        enc_out = shr.copy_to_model(enc_out, tp)
        k, v = (enc_out @ p[n].to(dtype) for n in ("wk", "wv"))
    else:
        k, v = (L.row_parallel(enc_out, p[n].to(dtype)) for n in ("wk", "wv"))
    shape = (B, Se, -1, cfg.hd)
    return k.reshape(shape), v.reshape(shape)


def _dec_block(blk, x, cfg: ArchConfig, dtype, self_attend, kc, vc,
               q_block: int):
    """One decoder block: self-attention through ``self_attend(q, k, v)``,
    non-causal cross-attention against ``kc``/``vc``, the GELU MLP."""
    h = L.layernorm(blk["ln_self"], x, cfg.norm_eps)
    q, k, v = _qkv(blk["self_attn"], h, cfg, dtype)
    x = x + L.attention_out(blk["self_attn"], self_attend(q, k, v), dtype)
    h = L.layernorm(blk["ln_cross"], x, cfg.norm_eps)
    qc = _cross_q(blk["cross_attn"], h, cfg, dtype)
    qc, kc, vc = L.attention_heads(qc, kc, vc, cfg.n_heads)
    cattn = L.blocked_attention(qc, kc, vc, causal=False, cross=True,
                                q_block=q_block, kv_block=cfg.kv_block)
    x = x + L.attention_out(blk["cross_attn"], cattn, dtype)
    h = L.layernorm(blk["ln_mlp"], x, cfg.norm_eps)
    return x + L.gelu_mlp(blk["mlp"], h, dtype)


def _dec_block_train(blk, x, enc_out, cfg: ArchConfig, dtype):
    def causal(q, k, v):
        q, k, v = L.attention_heads(q, k, v, cfg.n_heads)
        return L.blocked_attention(q, k, v, causal=True, q_block=cfg.q_block,
                                   kv_block=cfg.kv_block)
    kc, vc = _cross_kv(blk["cross_attn"], enc_out, cfg, dtype)
    return _dec_block(blk, x, cfg, dtype, causal, kc, vc, cfg.q_block)


def _dec_inputs(params, tokens, dtype, rows=None):
    """Token embeddings plus the learned positions: 0 .. S-1, or with
    ``rows`` ([B] positions) each row's own, clamped to the table as the
    reference's dynamic slice."""
    if rows is None:
        rows = torch.arange(tokens.shape[1], device=tokens.device)
    else:
        rows = rows.clamp(max=MAX_DEC_POSITIONS - 1)[:, None]
    pos = L.table_rows(params["pos_dec"], rows, MAX_DEC_POSITIONS, dtype)
    return L.embed(params["embed"], tokens, dtype) + pos


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
    tp = shr.active()
    H = cfg.n_heads // (tp.M if tp is not None and tp.split("act_kv_heads")
                        else 1)
    length, chunks = L.cache_extent(max_len, n_chunks)
    kv = L.KVCache.create(batch, cfg.n_heads, length, cfg.hd, chunks, dtype,
                          device)
    kv = L.KVCache(*(t.unsqueeze(0).repeat((Ld,) + (1,) * t.ndim)
                     for t in kv))
    z = torch.zeros((Ld, batch, cfg.max_source_len, H, cfg.hd),
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
            L.cache_prefill(kv, *L.whole_heads((k, "act_kv_heads"),
                                               (v, "act_kv_heads")))
            q, k, v = L.attention_heads(q, k, v, cfg.n_heads)
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
            q, k, v = L.whole_heads((q, "act_heads"), (k, "act_kv_heads"),
                                    (v, "act_kv_heads"))
            return L.flash_decode(q, L.cache_insert(kv, k, v))

        x = _dec_block(blk, x, cfg, dtype, cached, caches.cross_k[i],
                       caches.cross_v[i], 1)
    hidden = L.layernorm(params["ln_f"], x, cfg.norm_eps)
    return L.unembed(params["embed"], hidden)[:, 0], caches

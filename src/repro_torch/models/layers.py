"""Shared layer library (PyTorch port of ``repro.models.layers``).

Conventions, as in the JAX package:
  * params are nested dicts of tensors in the JAX ``[in, out]`` layout
    (``x @ w``); functions are plain functions of (params, activations);
  * activations compute in ``cfg.act_dtype``; weights are cast on entry with
    ``.to(dtype)``, which is a no-op (no copy) when they already are in it;
  * contractions the JAX package runs with ``preferred_element_type=f32``
    (attention scores, the vocab projection) produce float32 here too;
  * decode KV caches are chunked ``[B, kvH, n_chunks, chunk, hd]`` with the
    flash-decode log-sum-exp merge across chunks.

Two deliberate differences from the JAX package: the KV cache keeps one
length per batch row (so serving slots decode at independent positions
without a ``vmap``), and the cache writes update the tensors in place.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention.ops import FlashAttention
from ..kernels.flash_attention.ref import NEG, attention_ref


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_dense(gen, fan_in, shape, dtype):
    """``truncated_normal(-2, 2) / sqrt(fan_in)`` — the JAX ``_init_dense``
    in law, not in bits — by inverse-CDF sampling in float32, in place (one
    float32 buffer per leaf), on ``gen.device``."""
    lo, hi = (0.5 * (1 + math.erf(b / math.sqrt(2))) for b in (-2.0, 2.0))
    x = torch.rand(shape, generator=gen, device=gen.device)
    x.mul_(2 * (hi - lo)).add_(2 * lo - 1).erfinv_().mul_(math.sqrt(2))
    return x.clamp_(-2.0, 2.0).div_(math.sqrt(fan_in)).to(dtype)


def init_embedding(gen, vocab, d_model, dtype):
    """``{"table": 0.02 * normal [vocab, d_model]}`` on ``gen.device``."""
    return {"table": (0.02 * torch.randn((vocab, d_model), generator=gen,
                                         device=gen.device)).to(dtype)}


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(p, x, eps=1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"].float()).to(x.dtype)


def init_rmsnorm(shape, dtype=torch.float32, device=None):
    """``{"scale": ones}`` of ``shape`` (``[D]``, or ``[L, D]`` for stacked
    blocks)."""
    return {"scale": torch.ones(shape, dtype=dtype, device=device)}


def init_layernorm(shape, dtype=torch.float32, device=None):
    """``{"scale": ones, "bias": zeros}`` of ``shape`` (``[D]``, or
    ``[L, D]`` for stacked blocks)."""
    return {"scale": torch.ones(shape, dtype=dtype, device=device),
            "bias": torch.zeros(shape, dtype=dtype, device=device)}


def layernorm(p, x, eps=1e-5):
    """float32 statistics (population variance, two passes as ``jnp.var``),
    cast back to ``x``'s dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"].float()
            + p["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (incl. M-RoPE for qwen2-vl)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def mrope_sections(n_freqs: int) -> tuple[int, int, int]:
    """The reference's default M-RoPE split of the ``hd/2`` frequencies
    into (temporal, height, width) sections: ``(32, 16, 16)`` at hd 128."""
    return (n_freqs - 2 * (n_freqs // 4), n_freqs // 4, n_freqs // 4)


def rope_tables(positions, head_dim: int, theta: float, dtype):
    """(cos, sin) ``[B, S, 1, hd/2]`` in ``dtype`` — computed once per
    forward and shared by every layer. ``positions``: ``[B, S]``, or
    ``[3, B, S]`` temporal/height/width ids (M-RoPE), where frequency j
    takes the component of its section (:func:`mrope_sections`). The
    angles are float32 products, as the reference's, then cast."""
    inv = rope_freqs(head_dim, theta, positions.device)
    pos = positions.float()
    if positions.ndim == 3:
        sec_id = torch.repeat_interleave(
            torch.arange(3, device=pos.device),
            torch.tensor(mrope_sections(inv.shape[0]), device=pos.device))
        ang = pos[sec_id].permute(1, 2, 0) * inv         # [B, S, hd/2]
    else:
        ang = pos[..., None] * inv
    return (torch.cos(ang)[..., None, :].to(dtype),
            torch.sin(ang)[..., None, :].to(dtype))


def _rotate(x, cos, sin):
    hd = x.shape[-1]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def apply_rope(x, positions, theta: float):
    """x: [B, S, H, hd]; positions: [B, S] or [3, B, S] (M-RoPE)."""
    return _rotate(x, *rope_tables(positions, x.shape[-1], theta, x.dtype))


# ---------------------------------------------------------------------------
# attention (training / prefill)
# ---------------------------------------------------------------------------

def _naive_attention(q, k, v, *, causal, window, cross, return_lse=False):
    """Full (loop-free) attention, the test oracle: the kernel package's
    :func:`attention_ref` under the layer's ``cross`` flag."""
    return attention_ref(q, k, v, causal=causal and not cross, window=window,
                         return_lse=return_lse)


def blocked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      q_block: int = 512, kv_block: int = 512,
                      cross: bool = False):
    """Online-softmax blocked attention.

    q: [B, Sq, H, hd]; k, v: [B, Skv, kvH, hd] (GQA: H % kvH == 0).
    window > 0 => sliding-window causal attention; cross => no causal mask.

    On a CUDA tensor this is the hand-written flash-attention kernels
    through :class:`~repro_torch.kernels.flash_attention.ops.FlashAttention`
    (forward, and the dq / dkv backward when a gradient is asked for; their
    tiles are their own, so ``q_block``/``kv_block`` do not apply). On a CPU
    tensor it is the plain blocked path of the JAX package
    (``layers.py:149-207``), which never materialises more than
    ``[B, H, q_block, kv_block]`` scores, differentiated by autograd.
    """
    if q.is_cuda:
        return FlashAttention.apply(q, k, v, causal and not cross, window)
    B, Sq, H, hd = q.shape
    Skv, kvH = k.shape[1], k.shape[2]
    rep = H // kvH
    scale = 1.0 / math.sqrt(hd)
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Skv)
    nq, nk = -(-Sq // q_block), -(-Skv // kv_block)
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * q_block - Sq))
    kp = F.pad(k, (0, 0, 0, 0, 0, nk * kv_block - Skv))
    vp = F.pad(v, (0, 0, 0, 0, 0, nk * kv_block - Skv))
    q_pos_base = torch.arange(q_block, device=q.device)
    k_pos_base = torch.arange(kv_block, device=q.device)
    outs = []
    for qi in range(nq):
        qc = qp[:, qi * q_block:(qi + 1) * q_block] * scale  # [B, qb, H, hd]
        m = torch.full((B, H, q_block), NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, q_block), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, q_block, hd), dtype=torch.float32,
                          device=q.device)
        qpos = qi * q_block + q_pos_base
        for ki in range(nk):
            sl = slice(ki * kv_block, (ki + 1) * kv_block)
            kcr = torch.repeat_interleave(kp[:, sl], rep, dim=2)
            vcr = torch.repeat_interleave(vp[:, sl], rep, dim=2)
            s = torch.einsum("bqhd,bkhd->bhqk", qc.float(), kcr.float())
            kpos = ki * kv_block + k_pos_base
            mask = (kpos[None, :] <= Skv - 1) & (qpos[:, None] <= Sq - 1)
            if causal and not cross:
                off = Skv - Sq
                mask &= kpos[None, :] <= (qpos[:, None] + off)
                if window > 0:
                    mask &= kpos[None, :] > (qpos[:, None] + off - window)
            s = torch.where(mask[None, None], s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vcr.dtype).float(), vcr.float())
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.transpose(1, 2))                     # [B, qb, H, hd]
    out = torch.cat(outs, dim=1)
    return out[:, :Sq].to(q.dtype)


# ---------------------------------------------------------------------------
# chunked decode cache + flash-decode
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """k/v: [B, kvH, n_chunks, chunk, hd]; length: [B] tokens written per
    row (the JAX cache keeps one scalar; per-row lengths let serving slots
    sit at independent positions in one batch). Stacked per layer the
    leaves gain a leading ``[L]`` axis."""
    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    @staticmethod
    def create(batch, kv_heads, max_len, head_dim, n_chunks,
               dtype=torch.bfloat16, device=None):
        if max_len % n_chunks:
            raise ValueError(f"max_len={max_len} must be divisible by "
                             f"n_chunks={n_chunks}")
        chunk = max_len // n_chunks
        shape = (batch, kv_heads, n_chunks, chunk, head_dim)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros((batch,), dtype=torch.int64, device=device))


def cache_insert(cache: KVCache, k_new, v_new) -> KVCache:
    """Append one token's k/v ([B, 1, kvH, hd]) at each row's position
    ``cache.length``, in place.

    The JAX version writes with ``dynamic_update_slice``, which clamps an
    out-of-range start instead of failing; a torch indexed write would raise
    (on the GPU, as a device-side assert). To keep the JAX semantics the
    chunk index is clamped the same way, so a row decoded past ``max_len``
    (an idle serving slot) overwrites inside its last chunk as in JAX."""
    B, kvH, nc, ck, hd = cache.k.shape
    pos = cache.length
    ci = torch.clamp(pos // ck, max=nc - 1)
    co = pos % ck
    rows = torch.arange(B, device=pos.device)
    cache.k[rows, :, ci, co] = k_new[:, 0].to(cache.k.dtype)
    cache.v[rows, :, ci, co] = v_new[:, 0].to(cache.v.dtype)
    cache.length.add_(1)
    return cache


def cache_prefill(cache: KVCache, k_all, v_all) -> KVCache:
    """Bulk-write a prefill of S tokens ([B, S, kvH, hd]) from position 0,
    in place; the rest of the cache is zeroed as in the JAX version."""
    B, kvH, nc, ck, hd = cache.k.shape
    S = k_all.shape[1]
    for dst, src in ((cache.k, k_all), (cache.v, v_all)):
        flat = dst.view(B, kvH, nc * ck, hd)
        flat[:, :, :S] = src.transpose(1, 2).to(dst.dtype)
        flat[:, :, S:] = 0
    cache.length.fill_(S)
    return cache


def flash_decode(q, cache: KVCache, *, window: int = 0):
    """One-token decode attention against the chunked cache (plain torch,
    as in the JAX package). q: [B, 1, H, hd] -> [B, 1, H, hd].

    Each chunk computes a partial softmax (max, sum, weighted values), then
    the partials merge across chunks by log-sum-exp. GQA reads the shared
    kv head through a ``[B, kvH, rep, hd]`` view of q instead of repeating
    the cache; scores and partial values are float32."""
    B, _, H, hd = q.shape
    kvH, nc, ck = cache.k.shape[1], cache.k.shape[2], cache.k.shape[3]
    rep = H // kvH
    scale = 1.0 / math.sqrt(hd)
    qh = (q[:, 0] * scale).reshape(B, kvH, rep, hd).float()
    s = torch.einsum("bgrd,bgnkd->bgrnk", qh, cache.k.float())
    pos = torch.arange(nc * ck, device=q.device).reshape(1, nc, ck)
    length = cache.length.reshape(B, 1, 1)
    valid = pos < length
    if window > 0:
        valid &= pos > (length - window)
    s = torch.where(valid[:, None, None], s, NEG)            # [B, g, r, n, k]
    m = s.amax(dim=-1)                                      # [B, g, r, n]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    part = torch.einsum("bgrnk,bgnkd->bgrnd", p.to(cache.v.dtype).float(),
                        cache.v.float())
    g = m.amax(dim=-1, keepdim=True)
    w = torch.exp(m - g)
    den = (w * l).sum(dim=-1)
    num = (part * w[..., None]).sum(dim=3)                  # [B, g, r, hd]
    out = num / torch.clamp(den[..., None], min=1e-30)
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block + SwiGLU MLP
# ---------------------------------------------------------------------------

def attention_qkv(p, x, n_heads, n_kv_heads, head_dim, positions, theta,
                  dtype=torch.bfloat16, rope=None):
    """q/k/v projections plus RoPE. ``rope`` takes precomputed
    :func:`rope_tables` (else they are computed from ``positions``)."""
    B, S, _ = x.shape
    q = (x @ p["wq"].to(dtype)).reshape(B, S, n_heads, head_dim)
    k = (x @ p["wk"].to(dtype)).reshape(B, S, n_kv_heads, head_dim)
    v = (x @ p["wv"].to(dtype)).reshape(B, S, n_kv_heads, head_dim)
    if rope is None and positions is not None:
        rope = rope_tables(positions, head_dim, theta, q.dtype)
    if rope is not None:
        q = _rotate(q, *rope)
        k = _rotate(k, *rope)
    return q, k, v


def attention_out(p, attn, dtype=torch.bfloat16):
    B, S, H, hd = attn.shape
    return attn.reshape(B, S, H * hd) @ p["wo"].to(dtype)


def swiglu(p, x, dtype=torch.bfloat16):
    g = x @ p["w_gate"].to(dtype)
    u = x @ p["w_up"].to(dtype)
    return (F.silu(g) * u) @ p["w_down"].to(dtype)


def init_attention(gen, lead: tuple, d_model, n_heads, n_kv_heads, head_dim,
                   dtype):
    """q/k/v/o projections, stacked over the ``lead`` dims (``(L,)`` for
    a layer stack, ``()`` for one block)."""
    qd, kvd = n_heads * head_dim, n_kv_heads * head_dim
    return {"wq": init_dense(gen, d_model, lead + (d_model, qd), dtype),
            "wk": init_dense(gen, d_model, lead + (d_model, kvd), dtype),
            "wv": init_dense(gen, d_model, lead + (d_model, kvd), dtype),
            "wo": init_dense(gen, qd, lead + (qd, d_model), dtype)}


def init_swiglu(gen, lead: tuple, d_model, d_ff, dtype):
    return {"w_gate": init_dense(gen, d_model, lead + (d_model, d_ff), dtype),
            "w_up": init_dense(gen, d_model, lead + (d_model, d_ff), dtype),
            "w_down": init_dense(gen, d_ff, lead + (d_ff, d_model), dtype)}


def init_gelu_mlp(gen, lead: tuple, d_model, d_ff, dtype):
    dev = gen.device
    return {"w_up": init_dense(gen, d_model, lead + (d_model, d_ff), dtype),
            "b_up": torch.zeros(lead + (d_ff,), dtype=dtype, device=dev),
            "w_down": init_dense(gen, d_ff, lead + (d_ff, d_model), dtype),
            "b_down": torch.zeros(lead + (d_model,), dtype=dtype,
                                  device=dev)}


def gelu_mlp(p, x, dtype=torch.bfloat16):
    """``jax.nn.gelu``'s default is the tanh approximation (the erf form
    differs in the 4th digit)."""
    h = F.gelu(x @ p["w_up"].to(dtype) + p["b_up"].to(dtype),
               approximate="tanh")
    return h @ p["w_down"].to(dtype) + p["b_down"].to(dtype)


# ---------------------------------------------------------------------------
# embeddings / lm head
# ---------------------------------------------------------------------------

def embed(p, tokens, dtype=torch.bfloat16):
    """Gather rows, then cast: the table itself is never copied."""
    return F.embedding(tokens, p["table"]).to(dtype)


def _logits_f32(x2, table):
    """``[N, D] x [V, D] -> [N, V]`` float32, as the JAX einsum with bf16
    operands and ``preferred_element_type=f32``: on the GPU the product runs
    on the bf16 operands with a float32 result (``out_dtype``), so the vocab
    table is not copied; on the CPU the operands are widened (bf16 products
    are exact in f32, so both compute the same sums)."""
    if x2.is_cuda and x2.dtype != torch.float32:
        return torch.mm(x2, table.t(), out_dtype=torch.float32)
    return x2.float() @ table.float().t()


class _Logits(torch.autograd.Function):
    """:func:`_logits_f32` with its gradient: the float32 cotangent is cast
    to the operands' dtype and contracted with the other operand (the
    backward of the JAX einsum with a float32 ``preferred_element_type``
    returns cotangents in the operands' dtypes)."""

    @staticmethod
    def forward(ctx, x2, table):
        ctx.save_for_backward(x2, table)
        return _logits_f32(x2, table)

    @staticmethod
    def backward(ctx, g):
        x2, table = ctx.saved_tensors
        g = g.to(x2.dtype)
        return g @ table, g.t() @ x2


def unembed(p, x):
    """[B, S, D] x [V, D] -> float32 logits [B, S, V] (differentiable)."""
    table = p["table"].to(x.dtype)
    B, S, D = x.shape
    return _Logits.apply(x.reshape(B * S, D), table).reshape(B, S, -1)


def cross_entropy(logits, labels):
    """logits [B, S, V] f32, labels [B, S] -> mean NLL."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - ll)


def _chunk_nll(hc, table, lc):
    """Summed NLL of one ``[B, c, D]`` chunk of hidden states."""
    B, c, D = hc.shape
    logits = _Logits.apply(hc.reshape(B * c, D), table)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lc.reshape(B * c, 1).long())[:, 0]
    return torch.sum(lse - ll)


def cross_entropy_chunked(hidden, table_params, labels, chunk: int = 512):
    """Sequence-chunked CE: [B, S, D] hidden x [V, D] table -> mean NLL
    without ever materialising the [B, S, V] logits: each chunk of
    ``chunk`` positions runs under ``torch.utils.checkpoint``, so its
    logits are recomputed in the backward instead of kept (the JAX
    package's ``jax.checkpoint`` per chunk). The chunks' sums add in order,
    as the JAX ``lax.scan`` does."""
    B, S, D = hidden.shape
    table = table_params["table"].to(hidden.dtype)
    chunk = min(chunk, S)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, chunk):
        part = checkpoint(_chunk_nll, hidden[:, c0:c0 + chunk], table,
                          labels[:, c0:c0 + chunk], use_reentrant=False)
        tot = tot + part
    return tot / (B * S)

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

Under a :mod:`~repro_torch.models.sharding` rule table that splits over
'model' (tensor parallelism, M ranks) the functions take a rank's blocks
of the leaves and run the split forms: ``w_gate`` / ``w_up`` and a
head-split ``wq`` / ``wk`` / ``wv`` column-parallel, ``wo`` / ``w_down``
row-parallel (a partial sum reduced over 'model' in rank order), a
``wq`` / ``wk`` / ``wv`` split on its input dim (heads that do not divide
M) row-parallel with its output whole on every rank, vocab-parallel
``embed`` / ``unembed`` / ``cross_entropy_chunked`` on ``[V/M, D]``
blocks, a norm scale split on D gathered whole, and the decode cache's
chunk axis split over 'model' with the flash-decode partials merged in
chunk order. Outside such a table every function is its single-card
code.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import card_route
from ..kernels import work
from ..kernels.flash_attention.ops import FlashAttention
from ..kernels.flash_attention.ref import NEG, attention_ref
from . import sharding as shr


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

def whole_leaf(w, n: int, dim: int = -1):
    """A leaf whose ``dim`` should be ``n`` long: a rank's block of it
    (split over 'model') gathered whole, else ``w``."""
    tp = shr.active()
    if tp is None or w.shape[dim] == n:
        return w
    return shr.gather_from_model(w, tp, dim, "model_leaves")


def whole_leaves(p: dict, shapes: dict) -> dict:
    """``p`` with each leaf named in ``shapes`` (a path of keys joined by
    ``/`` -> its whole shape) whole: the blocks of those split over
    'model' gathered in one collective a dtype (``model_leaves``; the
    bytes of gathering each alone), the others as they are. Each
    gathered leaf's gradient is the rank's block of the whole one."""
    tp = shr.active()
    if tp is None:
        return p

    def get(path):
        node = p
        for k in path.split("/"):
            node = node[k]
        return node

    split = {}
    for path, shape in shapes.items():
        w = get(path)
        dims = [d for d, n in enumerate(shape) if w.shape[d] != n]
        if dims:
            split[path] = dims[0]
    if not split:
        return p
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in p.items()}
    # dtypes in a fixed order: a torch.dtype hashes by identity, so a set's
    # order differs between processes and the ranks' gathers would pair
    # different leaves
    for dtype in sorted({get(path).dtype for path in split}, key=str):
        paths = [path for path in split if get(path).dtype == dtype]
        packed = torch.cat([get(path).reshape(-1) for path in paths])
        rows = shr.gather_from_model(packed[None], tp, 0, "model_leaves")
        off = 0
        for path in paths:
            blk = get(path)
            n = blk.numel()
            parts = rows[:, off:off + n].reshape((tp.M,) + blk.shape)
            whole = torch.cat(list(parts.unbind(0)), dim=split[path])
            off += n
            node = out
            keys = path.split("/")
            for k in keys[:-1]:
                node = node[k]
            node[keys[-1]] = whole
    return out


def row_parallel(x, w, reduce: bool = True):
    """``x @ w`` for a replicated ``x [.., D]``: with ``w`` split over
    'model' on its input dim (fewer than D rows) this rank's block of
    ``x`` times its rows, the partials summed over 'model' (left as this
    rank's partial with ``reduce=False``, for a caller that joins several
    in one reduction); else the whole product."""
    tp = shr.active()
    if tp is None or w.shape[-2] == x.shape[-1]:
        return x @ w
    out = shr.scatter_to_model(x, tp) @ w
    return shr.reduce_from_model(out, tp) if reduce else out


def reduce_joined(*parts):
    """Several row-parallel partials (``row_parallel(..., reduce=False)``)
    summed over 'model' in one reduction: joined on their last dim, then
    split back."""
    tp = shr.active()
    sizes = [t.shape[-1] for t in parts]
    whole = shr.reduce_from_model(torch.cat(parts, dim=-1), tp)
    return whole.split(sizes, dim=-1)


def table_rows(table, idx, n: int, dtype):
    """Rows ``idx`` of a ``[n, D]`` table, cast to ``dtype``. With its
    rows split over 'model' a rank holds ``[m n/M, (m+1) n/M)``: an index
    outside them reads zeros, and the ranks' rows are summed (one is not
    zero: exact)."""
    if table.shape[0] == n:
        return table[idx].to(dtype)
    tp = shr.active()
    b = table.shape[0]
    local = idx - tp.m * b
    hit = ((local >= 0) & (local < b))[..., None]
    rows = F.embedding(local.clamp(0, b - 1), table).to(dtype) * hit
    return shr.reduce_from_model(rows, tp)


def rmsnorm(p, x, eps=1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    scale = whole_leaf(p["scale"], x.shape[-1])
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


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
    D = x.shape[-1]
    return ((xf - mu) * torch.rsqrt(var + eps)
            * whole_leaf(p["scale"], D).float()
            + whole_leaf(p["bias"], D).float()).to(x.dtype)


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
            torch.tensor(mrope_sections(inv.shape[0]), device=pos.device),
            output_size=inv.shape[0])
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
                      cross: bool = False, scale: float | None = None):
    """Online-softmax blocked attention.

    q: [B, Sq, H, hd]; k, v: [B, Skv, kvH, hd] (GQA: H % kvH == 0).
    window > 0 => sliding-window causal attention; cross => no causal mask.
    The scores are ``scale * q k^T``; ``scale`` defaults to ``1/sqrt(hd)``.

    On a CUDA or a meta tensor (:func:`~repro_torch.device.card_route`)
    this is the hand-written flash-attention kernels through
    :class:`~repro_torch.kernels.flash_attention.ops.FlashAttention`
    (forward, and the dq / dkv backward when a gradient is asked for; their
    tiles are their own, so ``q_block``/``kv_block`` do not apply); so is a
    CPU tensor while a work counter counts
    (:func:`repro_torch.kernels.work.counting`: the wrappers run their
    plain versions and report the kernels' work, so a CPU step is counted
    as the card's). Otherwise on a CPU tensor it is the plain blocked path
    of the JAX package
    (``layers.py:149-207``), which never materialises more than
    ``[B, H, q_block, kv_block]`` scores, differentiated by autograd.
    """
    if card_route(q) or work.counting():
        return FlashAttention.apply(q, k, v, causal and not cross, window,
                                    scale)
    B, Sq, H, hd = q.shape
    Skv, kvH = k.shape[1], k.shape[2]
    rep = H // kvH
    if scale is None:
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


def _cache_split():
    """``(M, m)`` of the decode cache's chunk axis: split over 'model'
    under a rule table with a ``kv_cache`` entry, else ``(1, 0)``."""
    tp = shr.active()
    if tp is not None and tp.split("kv_cache"):
        return tp.M, tp.m
    return 1, 0


def cache_extent(max_len: int, n_chunks: int) -> tuple[int, int]:
    """``(length, chunks)`` of this rank's decode cache of ``max_len``
    positions in ``n_chunks`` chunks: its ``n_chunks / M`` chunks when the
    chunk axis is split over 'model', else all."""
    M = _cache_split()[0]
    if n_chunks % M:
        raise ValueError(f"n_chunks={n_chunks} must divide over model={M}")
    return max_len // M, n_chunks // M


def cache_insert(cache: KVCache, k_new, v_new) -> KVCache:
    """Append one token's k/v ([B, 1, kvH, hd]) at each row's position
    ``cache.length``, in place.

    The JAX version writes with ``dynamic_update_slice``, which clamps an
    out-of-range start instead of failing; a torch indexed write would raise
    (on the GPU, as a device-side assert). To keep the JAX semantics the
    chunk index is clamped the same way, so a row decoded past ``max_len``
    (an idle serving slot) overwrites inside its last chunk as in JAX.
    With the chunk axis split over 'model' a rank holds chunks ``[m nc,
    (m+1) nc)`` and writes the rows whose position falls there (the others
    write back what they read: no host sync)."""
    B, kvH, nc, ck, hd = cache.k.shape
    M, m = _cache_split()
    pos = cache.length
    ci = torch.clamp(pos // ck, max=M * nc - 1)
    co = pos % ck
    rows = torch.arange(B, device=pos.device)
    if M == 1:
        cache.k[rows, :, ci, co] = k_new[:, 0].to(cache.k.dtype)
        cache.v[rows, :, ci, co] = v_new[:, 0].to(cache.v.dtype)
    else:
        mine = ((ci // nc) == m)[:, None, None]
        cl = torch.clamp(ci - m * nc, 0, nc - 1)
        for dst, src in ((cache.k, k_new), (cache.v, v_new)):
            dst[rows, :, cl, co] = torch.where(mine, src[:, 0].to(dst.dtype),
                                               dst[rows, :, cl, co])
    cache.length.add_(1)
    return cache


def cache_prefill(cache: KVCache, k_all, v_all) -> KVCache:
    """Bulk-write a prefill of S tokens ([B, S, kvH, hd]) from position 0,
    in place; the rest of the cache is zeroed as in the JAX version. With
    the chunk axis split over 'model' a rank writes its chunks'
    positions."""
    B, kvH, nc, ck, hd = cache.k.shape
    M, m = _cache_split()
    S = k_all.shape[1]
    start = m * nc * ck
    n = max(0, min(S - start, nc * ck))
    for dst, src in ((cache.k, k_all), (cache.v, v_all)):
        flat = dst.view(B, kvH, nc * ck, hd)
        flat[:, :, :n] = src[:, start:start + n].transpose(1, 2).to(
            dst.dtype)
        flat[:, :, n:] = 0
    cache.length.fill_(S)
    return cache


def flash_decode(q, cache: KVCache, *, window: int = 0,
                 scale: float | None = None):
    """One-token decode attention against the chunked cache (plain torch,
    as in the JAX package). q: [B, 1, H, hd] -> [B, 1, H, hd]; the scores
    are ``scale * q k^T`` (``scale`` defaults to ``1/sqrt(hd)``).

    Each chunk computes a partial softmax (max, sum, weighted values), then
    the partials merge across chunks by log-sum-exp. GQA reads the shared
    kv head through a ``[B, kvH, rep, hd]`` view of q instead of repeating
    the cache; scores and partial values are float32. With the chunk axis
    split over 'model' (q whole on every rank) each rank makes its chunks'
    partials and the partials of every rank are joined in chunk order
    before the merge: the single card's merge on the same numbers."""
    B, _, H, hd = q.shape
    kvH, nc, ck = cache.k.shape[1], cache.k.shape[2], cache.k.shape[3]
    M, mm = _cache_split()
    rep = H // kvH
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    qh = (q[:, 0] * scale).reshape(B, kvH, rep, hd).float()
    s = torch.einsum("bgrd,bgnkd->bgrnk", qh, cache.k.float())
    pos = torch.arange(nc * ck, device=q.device).reshape(1, nc, ck) \
        + mm * nc * ck
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
    if M > 1:   # one collective: [B, g, r, n, hd + 2]
        tp = shr.active()
        packed = shr.cat_ranks(tp.mesh, torch.cat(
            [part, m[..., None], l[..., None]], dim=-1), 3, "model")
        part, m, l = packed[..., :hd], packed[..., hd], packed[..., hd + 1]
    g = m.amax(dim=-1, keepdim=True)
    w = torch.exp(m - g)
    den = (w * l).sum(dim=-1)
    num = (part * w[..., None]).sum(dim=3)                  # [B, g, r, hd]
    out = num / torch.clamp(den[..., None], min=1e-30)
    return out.reshape(B, 1, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block + SwiGLU MLP
# ---------------------------------------------------------------------------

def _tp_proj(x, w, tp, name: str):
    """``x @ w`` for a replicated ``x [.., D]`` under the rule table:
    column-parallel (this rank's output block) when ``name`` is split over
    'model', row-parallel (``w`` split on its input dim; the output whole
    on every rank) when ``w`` holds fewer than D rows, else whole."""
    if tp.split(name):
        return shr.copy_to_model(x, tp) @ w
    if w.shape[-2] < x.shape[-1]:
        return shr.reduce_from_model(shr.scatter_to_model(x, tp) @ w, tp)
    return x @ w


def attention_qkv(p, x, n_heads, n_kv_heads, head_dim, positions, theta,
                  dtype=torch.bfloat16, rope=None):
    """q/k/v projections plus RoPE. ``rope`` takes precomputed
    :func:`rope_tables` (else they are computed from ``positions``).

    Split over 'model', q holds this rank's ``n_heads / M`` heads when the
    table has ``act_heads`` (else all), k and v theirs of ``n_kv_heads``
    under ``act_kv_heads`` (:func:`attention_heads` pairs them)."""
    B, S, _ = x.shape
    tp = shr.active()
    if tp is None:
        q = x @ p["wq"].to(dtype)
        k = x @ p["wk"].to(dtype)
        v = x @ p["wv"].to(dtype)
    else:
        if tp.split("act_heads") and tp.split("act_kv_heads"):
            xc = shr.copy_to_model(x, tp)     # one copy feeds all three
            q, k, v = (xc @ p[n].to(dtype) for n in ("wq", "wk", "wv"))
        else:
            q = _tp_proj(x, p["wq"].to(dtype), tp, "act_heads")
            k = _tp_proj(x, p["wk"].to(dtype), tp, "act_kv_heads")
            v = _tp_proj(x, p["wv"].to(dtype), tp, "act_kv_heads")
    q = q.reshape(B, S, -1, head_dim)
    k = k.reshape(B, S, -1, head_dim)
    v = v.reshape(B, S, -1, head_dim)
    if rope is None and positions is not None:
        rope = rope_tables(positions, head_dim, theta, q.dtype)
    if rope is not None:
        q = _rotate(q, *rope)
        k = _rotate(k, *rope)
    return q, k, v


def attention_heads(q, k, v, n_heads: int):
    """The k/v heads this rank's q heads attend to. Split over 'model'
    with q's heads split and k/v's whole (the kv heads do not divide M),
    each q head gets its kv head (one per q head, or one shared when the
    rank's heads share it), and k/v take the gradient of every rank's use;
    otherwise k/v as they are."""
    tp = shr.active()
    if tp is None or not tp.split("act_heads") or tp.split("act_kv_heads"):
        return q, k, v
    kvH = k.shape[2]
    h0, h1 = tp.block(n_heads)
    idx = torch.arange(h0, h1) // (n_heads // kvH)
    if bool((idx == idx[0]).all()):
        idx = idx[:1]
    idx = idx.to(k.device)
    k, v = (shr.copy_to_model(t, tp).index_select(2, idx) for t in (k, v))
    return q, k, v


def whole_heads(*ts):
    """``(t, name)`` pairs -> each ``t`` (a q / k / v ``[B, S, heads,
    hd]``) with this rank's heads joined over 'model' when ``name``
    (``act_heads`` / ``act_kv_heads``) is split (inference: the decode
    cache holds every head, and flash-decode takes every q head), else as
    it is. The split ones travel in one collective."""
    tp = shr.active()
    split = [tp is not None and tp.split(name) for _, name in ts]
    out = [t for t, _ in ts]
    if not any(split):
        return out
    parts = torch.cat([out[i] for i, s in enumerate(split) if s], dim=2)
    B, S, _, hd = parts.shape
    whole = shr.gather_ranks(tp.mesh, parts, "model").permute(1, 2, 0, 3, 4)
    j = 0
    for i, s in enumerate(split):
        if s:
            n = out[i].shape[2]
            out[i] = whole[:, :, :, j:j + n].reshape(B, S, tp.M * n, hd)
            j += n
    return out


def attention_out(p, attn, dtype=torch.bfloat16):
    """``attn [B, S, H', hd] @ wo``. Split over 'model' ``wo`` is
    row-parallel: this rank's heads (or its block of whole heads) times
    its rows of ``wo``, the partials summed over 'model'."""
    B, S, H, hd = attn.shape
    a = attn.reshape(B, S, H * hd)
    wo = p["wo"].to(dtype)
    tp = shr.active()
    if tp is None or wo.shape[-2] == H * hd and not tp.split("act_heads"):
        return a @ wo
    if wo.shape[-2] < H * hd:
        a = shr.scatter_to_model(a, tp)
    return shr.reduce_from_model(a @ wo, tp)


def swiglu(p, x, dtype=torch.bfloat16):
    tp = shr.active()
    split = tp is not None and tp.split("act_ffn")
    if split:
        x = shr.copy_to_model(x, tp)
    g = x @ p["w_gate"].to(dtype)
    u = x @ p["w_up"].to(dtype)
    out = (F.silu(g) * u) @ p["w_down"].to(dtype)
    return shr.reduce_from_model(out, tp) if split else out


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
    tp = shr.active()
    w_up, w_down = p["w_up"].to(dtype), p["w_down"].to(dtype)
    split = tp is not None and tp.split("act_ffn")
    if split:
        # column-parallel w_up (this rank's F block, and its block of
        # b_up: the table splits both on F), row-parallel w_down; b_down
        # added once, after the sum
        x = shr.copy_to_model(x, tp)
    h = F.gelu(x @ w_up + p["b_up"].to(dtype), approximate="tanh")
    out = h @ w_down
    if split:
        out = shr.reduce_from_model(out, tp)
    b_down = whole_leaves(p, {"b_down": (out.shape[-1],)})["b_down"]
    return out + b_down.to(dtype)


# ---------------------------------------------------------------------------
# embeddings / lm head
# ---------------------------------------------------------------------------

def _vocab_split():
    """The rule table when the vocab (``logits``) is split over 'model'."""
    tp = shr.active()
    return tp if tp is not None and tp.split("logits") else None


def embed(p, tokens, dtype=torch.bfloat16):
    """Gather rows, then cast: the table itself is never copied. With the
    vocab split over 'model' a rank holds rows ``[m V/M, (m+1) V/M)``: a
    token outside them reads zeros, and the ranks' rows are summed (one
    is not zero: exact)."""
    tp = _vocab_split()
    if tp is None:
        return F.embedding(tokens, p["table"]).to(dtype)
    table = p["table"]
    n = table.shape[0]
    local = tokens - tp.m * n
    hit = ((local >= 0) & (local < n))[..., None]
    e = F.embedding(local.clamp(0, n - 1), table) * hit
    return shr.reduce_from_model(e, tp).to(dtype)


def _logits_f32(x2, table):
    """``[N, D] x [V, D] -> [N, V]`` float32, as the JAX einsum with bf16
    operands and ``preferred_element_type=f32``: on the GPU the product runs
    on the bf16 operands with a float32 result (``out_dtype``), so the vocab
    table is not copied; on the CPU the operands are widened (bf16 products
    are exact in f32, so both compute the same sums)."""
    if card_route(x2) and x2.dtype != torch.float32:
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


def _logits2(x2, table):
    """``[N, D]`` hidden -> float32 logits of the rows of ``table`` this
    rank holds (vocab-parallel: the hidden is a replicated input)."""
    tp = _vocab_split()
    if tp is not None:
        x2 = shr.copy_to_model(x2, tp)
    return _Logits.apply(x2, table)


def unembed(p, x):
    """[B, S, D] x [V, D] -> float32 logits [B, S, V] (differentiable);
    ``[B, S, V/M]``, this rank's vocab block, with the vocab split over
    'model' (:func:`argmax_vocab` and :func:`gather_vocab` read it)."""
    table = p["table"].to(x.dtype)
    B, S, D = x.shape
    return _logits2(x.reshape(B * S, D), table).reshape(B, S, -1)


def gather_vocab(logits):
    """Vocab-split logits ``[..., V/M]`` joined over 'model' to ``[...,
    V]`` (inference), or ``logits`` when the vocab is whole."""
    tp = _vocab_split()
    if tp is None:
        return logits
    return shr.cat_ranks(tp.mesh, logits, logits.ndim - 1, "model")


def argmax_vocab(logits):
    """``argmax`` over the last dim of (vocab-split) logits: each rank's
    first maximum, then the first rank with the largest value, so ties
    take the lowest index, as ``torch.argmax`` does on one card."""
    tp = _vocab_split()
    if tp is None:
        return torch.argmax(logits, dim=-1)
    val, idx = torch.max(logits, dim=-1)
    idx = idx + tp.m * logits.shape[-1]
    vals = shr.cat_ranks(tp.mesh, val[None].float(), 0, "model")
    idxs = shr.cat_ranks(tp.mesh, idx[None], 0, "model")
    best = torch.argmax(vals, dim=0, keepdim=True)
    return torch.gather(idxs, 0, best)[0]


def cross_entropy(logits, labels):
    """logits [B, S, V] f32, labels [B, S] -> mean NLL."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - ll)


class _VocabNLL(torch.autograd.Function):
    """Per-row NLL of vocab-split float32 logits ``[N, V/M]``: the max and
    the sum of exponentials over every rank's block (gathered, summed in
    rank order) and the label's logit from the rank that holds it; the
    gradient is ``softmax - onehot`` on the rank's block."""

    @staticmethod
    def forward(ctx, logits, labels, tp):
        n = logits.shape[1]
        mesh = tp.mesh
        gmax = shr.cat_ranks(mesh, logits.amax(dim=1)[None], 0,
                             "model_loss").amax(dim=0)
        sumexp = shr.sum_ranks(mesh, torch.exp(logits - gmax[:, None])
                               .sum(dim=1), "model_loss")
        lse = gmax + torch.log(sumexp)
        local = labels.long() - tp.m * n
        hit = (local >= 0) & (local < n)
        lc = local.clamp(0, n - 1)
        ll = torch.gather(logits, 1, lc[:, None])[:, 0] * hit
        ll = shr.sum_ranks(mesh, ll, "model_loss")
        ctx.save_for_backward(logits, lse, lc, hit)
        return lse - ll

    @staticmethod
    def backward(ctx, g):
        logits, lse, lc, hit = ctx.saved_tensors
        grad = torch.exp(logits - lse[:, None])
        grad[torch.arange(grad.shape[0], device=grad.device), lc] -= \
            hit.to(grad.dtype)
        return grad * g[:, None], None, None


def _chunk_nll(hc, table, lc):
    """Summed NLL of one ``[B, c, D]`` chunk of hidden states."""
    B, c, D = hc.shape
    logits = _logits2(hc.reshape(B * c, D), table)
    tp = _vocab_split()
    if tp is not None:
        return torch.sum(_VocabNLL.apply(logits, lc.reshape(B * c), tp))
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lc.reshape(B * c, 1).long())[:, 0]
    return torch.sum(lse - ll)


def cross_entropy_chunked(hidden, table_params, labels, chunk: int = 512):
    """Sequence-chunked CE: [B, S, D] hidden x [V, D] table -> mean NLL
    without ever materialising the [B, S, V] logits: each chunk of
    ``chunk`` positions runs under ``torch.utils.checkpoint``, so its
    logits are recomputed in the backward instead of kept (the JAX
    package's ``jax.checkpoint`` per chunk). The chunks' sums add in order,
    as the JAX ``lax.scan`` does. With the vocab split over 'model' each
    chunk's logits are the rank's block and the loss statistics cross
    ranks (the same chunks)."""
    B, S, D = hidden.shape
    table = table_params["table"].to(hidden.dtype)
    chunk = min(chunk, S)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, chunk):
        part = checkpoint(_chunk_nll, hidden[:, c0:c0 + chunk], table,
                          labels[:, c0:c0 + chunk], use_reentrant=False)
        tot = tot + part
    return tot / (B * S)

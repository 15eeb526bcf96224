"""Mixture-of-Experts decoder (PyTorch port of ``repro.models.moe``):
dbrx-132b (16 experts, top-4) and qwen3-moe-235b-a22b (128 experts,
top-8).

The attention half is the dense transformer's (``transformer.py``, through
its ``ffn`` hook), KV cache included. The FFN routes token-choice top-k
with a per-expert capacity ``C = max(int(T * top_k / E *
capacity_factor), 1)`` clipped to T — the reference's expression, which
truncates — and drops the tokens beyond it: each expert takes its top-C
tokens by routing weight into ``[E, C, D]``, the experts run as batched
matmuls over all E, and the outputs are combined back per token. Tokens
past ``MOE_CHUNK_TOKENS`` route in equal chunks, capacity per chunk.

Where a straightforward port would differ from the reference:
  * top-k order: both picks (a token's experts, an expert's tokens) take
    the first k of a stable descending sort, so ties go to the lower index
    as in ``jax.lax.top_k`` (``torch.topk`` breaks them otherwise, and
    router logits from a bf16 matmul tie often);
  * the combine adds a token's contributions one at a time in the
    activation dtype, in ascending expert order — the order of the
    reference's scatter-add over its ``[E, C]`` updates — by gathers, with
    no atomics, so it is deterministic on the card;
  * the tokens of one call route together and compete for capacity. The
    serving loop's ``decode_replicas`` therefore decodes each batch row (a
    serving slot) on its own, at B = 1 shapes, as the reference service's
    ``vmap`` over B = 1 slots does: a slot's tokens equal its own
    single-request run bit for bit. ``decode_step`` (the launch driver)
    routes its B rows together, as the reference's does.

Tensor parallelism (the 'model' axis; the attention half is the dense
transformer's): ``w_gate`` / ``w_up`` are column-parallel and ``w_down``
row-parallel on F, so each rank runs every expert on its F block. The
router is gathered whole at use (its D is split by the per-leaf table),
so the logits, the stable top-k and the capacity drops are computed from
whole operands, bit-equal on every rank. The one reduction over 'model'
sums the combined ``[T, D]`` partials, after the combine (``k *
capacity_factor`` times fewer bytes than the ``[E, C, D]`` expert
outputs); the routing weights take every rank's part of their gradient
(``copy_to_model``), since each rank's partial outputs give a part of it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers as L
from . import sharding as shr
from . import transformer as TF
from .config import ArchConfig

MOE_CHUNK_TOKENS = 131_072  # route in token chunks beyond this (prefill)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_moe_ffn(gen: torch.Generator, cfg: ArchConfig, dtype):
    """Stacked ``[L, ...]`` router ``[D, E]`` (the dense law) and experts
    ``[E, D, F]`` / ``[E, F, D]`` (``0.02 * normal``)."""
    Lyr, E, D, Fd = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff

    def normal(shape):
        x = torch.randn(shape, generator=gen, device=gen.device)
        return x.mul_(0.02).to(dtype)

    return {"router": L.init_dense(gen, D, (Lyr, D, E), dtype),
            "w_gate": normal((Lyr, E, D, Fd)),
            "w_up": normal((Lyr, E, D, Fd)),
            "w_down": normal((Lyr, E, Fd, D))}


def init(gen: torch.Generator, cfg: ArchConfig, dtype=torch.float32):
    """Random params on ``gen.device`` in ``dtype``, the reference's tree
    (``blocks/moe`` in place of ``blocks/mlp``)."""
    Lyr, D, dev = cfg.n_layers, cfg.d_model, gen.device
    init_norm = TF._norm_fns(cfg)[0]
    return {"embed": L.init_embedding(gen, cfg.vocab, D, dtype),
            "blocks": {"ln_attn": init_norm((Lyr, D), dtype, dev),
                       "attn": TF.init_attention(gen, cfg, dtype),
                       "ln_mlp": init_norm((Lyr, D), dtype, dev),
                       "moe": init_moe_ffn(gen, cfg, dtype)},
            "ln_f": init_norm(D, dtype, dev)}


# ---------------------------------------------------------------------------
# routing, experts, combine
# ---------------------------------------------------------------------------

def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (``jax.lax.top_k``'s order): the head of a stable
    descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(T: int, cfg: ArchConfig) -> int:
    """Tokens per expert for T routed tokens (``int``, as the reference)."""
    cap = max(int(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 1)
    return min(cap, T)


def route(logits: torch.Tensor, k: int, cap: int):
    """[T, E] float32 router logits -> (wcap [E, C] the routing weights of
    each expert's top-C tokens, tok_idx [E, C] those tokens, topi [T, k] the
    experts of each token)."""
    probs = torch.softmax(logits, dim=-1)
    topw, topi = top_k(probs, k)
    topw = topw / torch.clamp_min(topw.sum(dim=-1, keepdim=True), 1e-9)
    wmap = torch.zeros_like(probs).scatter(-1, topi, topw)        # [T, E]
    wcap, tok_idx = top_k(wmap.t(), cap)                          # [E, C]
    return wcap, tok_idx, topi


def slots(tok_idx: torch.Tensor, keep: torch.Tensor,
          topi: torch.Tensor) -> torch.Tensor:
    """``pos [T, K]``: for each token's experts in ascending order, the
    row ``e * C + c`` of the slot that kept it, or ``E * C`` (a zero row)
    where the expert dropped it."""
    E, C = tok_idx.shape
    T = topi.shape[0]
    dev = tok_idx.device
    pos = torch.full((T + 1, E), E * C, dtype=torch.long, device=dev)
    # unkept slots all land in row T, which is cut off
    pos[torch.where(keep, tok_idx, T),
        torch.arange(E, device=dev)[:, None].expand(E, C)] = \
        torch.arange(E * C, device=dev).reshape(E, C)
    return pos[:T].gather(1, torch.sort(topi, dim=-1).values)


def sum_slots(rows: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``[T, D]``: row t is ``rows[pos[t, 0]] + rows[pos[t, 1]] + ...``,
    added one at a time from zero in ``rows``' dtype (a ``pos`` of
    ``len(rows)`` adds nothing) — the reference's scatter-add order over
    its ``[E, C]`` updates, with gathers in place of atomics."""
    T, K = pos.shape
    flat = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
    parts = flat.index_select(0, pos.reshape(-1)).reshape(T, K, -1)
    acc = rows.new_zeros((T, rows.shape[1]))
    for j in range(K):
        acc = acc + parts[:, j]
    return acc


class _Dispatch(torch.autograd.Function):
    """``xt [T, D]`` -> its rows ``idx`` (each expert's C tokens). The
    backward adds a token's gradients from its kept slots by
    :func:`sum_slots` (the reference's scatter-add order; an unkept slot's
    gradient is exactly zero), not by ``index_add_``, whose order on the
    card is unfixed."""

    @staticmethod
    def forward(ctx, xt, idx, pos):
        ctx.save_for_backward(pos)
        return xt.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        return sum_slots(g, pos), None, None


def moe_tokens(p, xt: torch.Tensor, cfg: ArchConfig, dtype) -> torch.Tensor:
    """One routing group: ``xt [T, D]`` -> ``[T, D]`` (the reference's
    ``_moe_tokens`` on the group's tokens flattened)."""
    T, D = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    cap = capacity(T, cfg)
    tp = shr.active()
    # the router whole on every 'model' rank: the same logits, top-k and
    # capacity drops on each, so every rank dispatches the same tokens
    router = L.whole_leaves(p, {"router": (D, E)})["router"]
    logits = (xt @ router.to(dtype)).float()
    wcap, tok_idx, topi = route(logits, K, cap)
    keep = wcap > 0.0
    pos = slots(tok_idx, keep, topi)
    weights = wcap * keep
    split = tp is not None and p["w_gate"].shape[-1] < cfg.d_ff
    if split:   # each rank's F block of every expert: partial outputs
        xt = shr.copy_to_model(xt, tp)
        weights = shr.copy_to_model(weights, tp)
    x = _Dispatch.apply(xt, tok_idx.reshape(-1), pos).reshape(E, cap, D)
    g = torch.bmm(x, p["w_gate"].to(dtype))
    u = torch.bmm(x, p["w_up"].to(dtype))
    out = torch.bmm(F.silu(g) * u, p["w_down"].to(dtype))         # [E, C, D]
    out = out * weights[..., None].to(dtype)
    out = sum_slots(out.reshape(E * cap, D), pos)
    # one reduction of the combined [T, D] partials, after the combine
    return shr.reduce_from_model(out, tp) if split else out


def moe_ffn(p, x: torch.Tensor, cfg: ArchConfig, dtype) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D]; the B * S tokens route as one group, or
    past ``MOE_CHUNK_TOKENS`` in the reference's equal chunks, one after
    the other (capacity per chunk, the ``[E, C, D]`` transient bounded)."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    nc = 1
    if T > MOE_CHUNK_TOKENS:
        nc = -(-T // MOE_CHUNK_TOKENS)
        while T % nc:
            nc += 1
    out = torch.cat([moe_tokens(p, c, cfg, dtype) for c in xt.chunk(nc)])
    return out.reshape(B, S, D)


def _ffn(blk, h, cfg: ArchConfig, dtype):
    return moe_ffn(blk["moe"], h, cfg, dtype)


# ---------------------------------------------------------------------------
# training and inference: the dense transformer with the MoE FFN
# ---------------------------------------------------------------------------

def forward(params, tokens, *, cfg: ArchConfig, remat: bool = True):
    return TF.forward(params, tokens, cfg=cfg, remat=remat, ffn=_ffn)


def loss(params, batch, *, cfg: ArchConfig):
    return TF.loss(params, batch, cfg=cfg, ffn=_ffn)


init_caches = TF.init_caches
cache_rows = TF.cache_rows
reset_cache_rows = TF.reset_cache_rows


def prefill_replicas(reps, tokens, caches, *, cfg: ArchConfig):
    """``transformer.prefill_replicas`` with the MoE FFN: each replica
    routes the ``[B, S]`` tokens as one group; the attention of all
    replicas runs in one launch."""
    return TF.prefill_replicas(reps, tokens, caches, cfg=cfg, ffn=_ffn)


def decode_replicas(reps, caches, tokens, *, cfg: ArchConfig):
    """The serving loop's decode: each row of ``tokens [B, 1]`` (a slot)
    routes alone and runs at B = 1 shapes against its rows of the caches.
    Returns logits ``[R, B, V]``; caches are updated in place."""
    return torch.cat([
        TF.decode_replicas(reps, [cache_rows(c, slice(b, b + 1))
                                  for c in caches],
                           tokens[b:b + 1], cfg=cfg, ffn=_ffn)
        for b in range(tokens.shape[0])], dim=1)


def prefill(params, batch, caches, *, cfg: ArchConfig):
    """Returns (last-token logits [B, V] float32, filled caches)."""
    logits = prefill_replicas([params], batch["tokens"], [caches], cfg=cfg)
    return logits[0], caches


def decode_step(params, caches, batch, *, cfg: ArchConfig):
    """batch: {"token": [B, 1]}; the B tokens route as one group."""
    logits = TF.decode_replicas([params], [caches], batch["token"], cfg=cfg,
                                ffn=_ffn)
    return logits[0], caches

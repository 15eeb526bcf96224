"""Plain float32 reference of the dense decoder (``model_type`` ``phi3``:
Phi-4-mini) as the port runs it: pre-norm RMSNorm blocks of grouped-query
attention with rotary positions on every head dim, a SwiGLU MLP, a final
RMSNorm, and the input embedding reused as the output head when the
configuration ties them. Plain ``torch`` operations only: full causal
softmax attention, no kernels, no cache, no batching of rows.

Departures from the published model (noted in the configuration's file):
the rotation covers the whole head (the published model rotates 3/4 of it)
and the long-context rotary rescaling is left out.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def dims(c: dict) -> dict:
    D, H = c["hidden_size"], c["num_attention_heads"]
    return dict(D=D, H=H, kvH=c["num_key_value_heads"],
                hd=c.get("head_dim") or D // H, F=c["intermediate_size"],
                V=c["vocab_size"], L=c["num_hidden_layers"],
                theta=float(c["rope_theta"]), eps=float(c["rms_norm_eps"]),
                tied=bool(c["tie_word_embeddings"]))


def leaf_table(c: dict) -> list[tuple[str, tuple, tuple, bool]]:
    """``(path, shape, init law, multiplies)`` of every parameter, sorted by
    path. Matrices are ``[in, out]``, stacked over the layers. The init
    laws are :mod:`bench.inputs`' (``("clipped", std)``: a normal clipped at
    two deviations; ``("normal", std)``; ``("const", value)``), with the
    port's deviations: one over the square root of a matrix's input width,
    0.02 for the embedding. ``multiplies`` marks the leaves a token
    multiplies through (the embedding only as the tied output head)."""
    d = dims(c)
    D, H, kvH, hd, Fd, V, L = (d[k] for k in ("D", "H", "kvH", "hd", "F",
                                               "V", "L"))
    def mat(n_in, n_out):
        return (L, n_in, n_out), ("clipped", 1.0 / math.sqrt(n_in)), True

    ones = ("const", 1.0)
    leaves = [
        ("blocks/attn/wq", *mat(D, H * hd)),
        ("blocks/attn/wk", *mat(D, kvH * hd)),
        ("blocks/attn/wv", *mat(D, kvH * hd)),
        ("blocks/attn/wo", *mat(H * hd, D)),
        ("blocks/ln_attn/scale", (L, D), ones, False),
        ("blocks/ln_mlp/scale", (L, D), ones, False),
        ("blocks/mlp/w_gate", *mat(D, Fd)),
        ("blocks/mlp/w_up", *mat(D, Fd)),
        ("blocks/mlp/w_down", *mat(Fd, D)),
        ("embed/table", (V, D), ("normal", 0.02), d["tied"]),
        ("ln_f/scale", (D,), ones, False),
    ]
    if not d["tied"]:
        leaves.append(("lm_head/table", (V, D),
                       ("clipped", 1.0 / math.sqrt(D)), True))
    return sorted(leaves)


def model_flops(c: dict, rows: int, seq: int) -> float:
    """Forward and backward operations of one ``[rows, seq]`` batch: six a
    multiplying parameter a token, and causal attention's two products
    forward and four backward over the visible pairs (two operations a
    multiply-add). Recomputation is not counted."""
    d = dims(c)
    mult = sum(math.prod(s) for _, s, _, m in leaf_table(c) if m)
    pairs = seq * (seq + 1) // 2
    attn = 12.0 * d["hd"] * pairs * d["H"] * d["L"] * rows
    return 6.0 * mult * rows * seq + attn


def attention_calls(c: dict, rows: int, seq: int) -> list[dict]:
    """The flash-attention calls of one ``[rows, seq]`` batch's forward,
    one a layer: causal self-attention over the whole sequence, in the
    keyword shapes of :mod:`bench.yardstick`'s ``flash_*_work``."""
    d = dims(c)
    return [dict(B=rows, Sq=seq, Skv=seq, H=d["H"], kvH=d["kvH"],
                 hd=d["hd"])] * d["L"]


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def _rope(x, cos, sin):
    half = x.shape[-1] // 2
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _block(x, p, i, d, cos, sin):
    B, S = x.shape[:2]
    H, kvH, hd = d["H"], d["kvH"], d["hd"]
    h = _rmsnorm(x, p["blocks/ln_attn/scale"][i], d["eps"])
    q = (h @ p["blocks/attn/wq"][i]).view(B, S, H, hd)
    k = (h @ p["blocks/attn/wk"][i]).view(B, S, kvH, hd)
    v = (h @ p["blocks/attn/wv"][i]).view(B, S, kvH, hd)
    q, k = _rope(q, cos, sin), _rope(k, cos, sin)
    group = H // kvH
    k = k.repeat_interleave(group, dim=2)          # q head j reads j // group
    v = v.repeat_interleave(group, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    att = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
    x = x + att.reshape(B, S, H * hd) @ p["blocks/attn/wo"][i]
    h = _rmsnorm(x, p["blocks/ln_mlp/scale"][i], d["eps"])
    mlp = (F.silu(h @ p["blocks/mlp/w_gate"][i]) * (h @ p["blocks/mlp/w_up"][i])
           ) @ p["blocks/mlp/w_down"][i]
    return x + mlp


def _nll_sum(h, table, labels):
    logits = h @ table.t()
    return torch.sum(torch.logsumexp(logits, dim=-1)
                     - logits.gather(1, labels[:, None])[:, 0])


def loss(p: dict, tokens, labels, c: dict, chunk: int = 4096):
    """Mean next-token NLL of a batch (``tokens``, ``labels``: ``[B, S]``
    int64) at parameters ``p`` (path -> float32 tensor). Each block and
    each chunk of ``chunk`` tokens of the output head runs under
    activation checkpointing, so 4 rows of 4096 positions fit beside the
    replica stack."""
    d = dims(c)
    S = tokens.shape[1]
    inv = 1.0 / (d["theta"] ** (torch.arange(0, d["hd"], 2, device=tokens.device,
                                             dtype=torch.float32) / d["hd"]))
    ang = torch.arange(S, device=tokens.device, dtype=torch.float32)[:, None] \
        * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x = p["embed/table"][tokens]
    for i in range(d["L"]):
        x = checkpoint(_block, x, p, i, d, cos, sin, use_reentrant=False)
    h = _rmsnorm(x, p["ln_f/scale"], d["eps"]).reshape(-1, d["D"])
    table = p["embed/table"] if d["tied"] else p["lm_head/table"]
    flat = labels.reshape(-1)
    tot = h.new_zeros(())
    for c0 in range(0, flat.shape[0], chunk):
        tot = tot + checkpoint(_nll_sum, h[c0:c0 + chunk], table,
                               flat[c0:c0 + chunk], use_reentrant=False)
    return tot / flat.shape[0]

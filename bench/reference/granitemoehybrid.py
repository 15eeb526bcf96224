"""Plain float32 reference of Granite 4.0-H (``model_type``
``granitemoehybrid`` with no experts: granite-4.0-h-micro) as the port
runs it, from the published equations (transformers'
``GraniteMoeHybridForCausalLM``: the layer, ``BambaMixer.torch_forward``,
``BambaRMSNormGated``, ``GraniteMoeSharedMLP``):

    x = embedding_multiplier * E[tokens]
    per layer (layer_types[i]: "mamba" or "attention"):
        x = x + residual_multiplier * mixer(rmsnorm(x))
        x = x + residual_multiplier * swiglu(rmsnorm(x))
    logits = rmsnorm(x) E^T / logits_scaling

The Mamba2 mixer: one input projection to (z, x, B, C, dt); a causal
depthwise conv with bias and SiLU over (x, B, C); dt = softplus(dt +
dt_bias); per head the recurrence

    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) (x) B_t,   y_t = C_t . h_t + D x_t

with A = -exp(A_log) and one B/C group shared by every head; then
rmsnorm(y * silu(z)) and the output projection. The recurrence is computed
exactly by chunks of ``mamba_chunk_size`` steps (:func:`ssd`): within a
chunk a masked decay matrix, across chunks the state carried by a loop.
Attention: grouped-query, causal, no positional embedding, softmax scale
``attention_multiplier``. Plain ``torch`` operations only, TF32 off.

Departures from the published model, all the port's (noted in the
configuration's file): the log decay ``dt A`` is floored at -20, as the
port floors it. Layout: matrices are ``[in, out]``; the depthwise conv's
weight is ``[K, channels]`` with ``w[k]`` the tap of the input ``k``
steps back (the published ``Conv1d`` weight ``[channels, 1, K]`` in
reverse tap order).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LOG_DECAY_FLOOR = -20.0
#: ``dt_bias``'s law: softplus^-1(0.01), the geometric middle of Mamba2's
#: [1e-3, 1e-1] range of dt
DT_BIAS = math.log(math.expm1(0.01))
#: ``A_log``'s law: uniform in [0, ln 16), so A is log-uniform on [1, 16)
A_LOG_MAX = math.log(16.0)


def dims(c: dict) -> dict:
    if c.get("mamba_n_groups", 1) != 1 or c.get("num_local_experts", 0) \
            or c.get("position_embedding_type") != "nope" \
            or not c["tie_word_embeddings"]:
        raise ValueError("the reference runs one B/C group, no experts, no "
                         "positional embedding and a tied head")
    D, nH = c["hidden_size"], c["num_attention_heads"]
    L = c["num_hidden_layers"]
    E = c["mamba_expand"] * D
    H = c["mamba_n_heads"]
    return dict(D=D, E=E, H=H, P=E // H, N=c["mamba_d_state"],
                K=c["mamba_d_conv"], nH=nH, kvH=c["num_key_value_heads"],
                hd=D // nH, F=c["shared_intermediate_size"],
                V=c["vocab_size"], L=L, kinds=list(c["layer_types"][:L]),
                eps=float(c["rms_norm_eps"]),
                emb=float(c["embedding_multiplier"]),
                res=float(c["residual_multiplier"]),
                att=float(c["attention_multiplier"]),
                logit=float(c["logits_scaling"]),
                chunk=c["mamba_chunk_size"])


def _index(d: dict) -> list[int]:
    """Each layer's index in its kind's stack."""
    seen = {"mamba": 0, "attention": 0}
    out = []
    for k in d["kinds"]:
        out.append(seen[k])
        seen[k] += 1
    return out


def leaf_table(c: dict) -> list[tuple[str, tuple, tuple, bool]]:
    """``(path, shape, init law, multiplies)`` of every parameter, sorted by
    path (see :func:`bench.reference.phi3.leaf_table`): the Mamba2 layers'
    leaves stacked under ``mamba/``, the attention layers' under
    ``attn/``, every layer's norms and MLP under ``ln_mix/``, ``ln_mlp/``
    and ``mlp/``. Laws: matrices and the depthwise conv clipped normal
    over the square root of their fan-in (the conv's is its width K), the
    conv's bias 0, the embedding normal 0.02, ``A_log`` uniform in [0, ln
    16), ``dt_bias`` :data:`DT_BIAS`, ``D_skip`` and the norms 1."""
    d = dims(c)
    D, E, H, N, K, F_, V, L = (d[k] for k in ("D", "E", "H", "N", "K", "F",
                                              "V", "L"))
    Lm, La = d["kinds"].count("mamba"), d["kinds"].count("attention")
    qd, kvd = d["nH"] * d["hd"], d["kvH"] * d["hd"]
    conv = E + 2 * N

    def mat(n, n_in, n_out):
        return (n, n_in, n_out), ("clipped", 1.0 / math.sqrt(n_in)), True

    ones = ("const", 1.0)
    leaves = [("embed/table", (V, D), ("normal", 0.02), True),
              ("ln_f/scale", (D,), ones, False),
              ("ln_mix/scale", (L, D), ones, False),
              ("ln_mlp/scale", (L, D), ones, False),
              ("mlp/w_gate", *mat(L, D, F_)),
              ("mlp/w_up", *mat(L, D, F_)),
              ("mlp/w_down", *mat(L, F_, D))]
    if La:
        leaves += [("attn/wq", *mat(La, D, qd)), ("attn/wk", *mat(La, D, kvd)),
                   ("attn/wv", *mat(La, D, kvd)), ("attn/wo", *mat(La, qd, D))]
    if Lm:
        leaves += [("mamba/in_proj", *mat(Lm, D, 2 * E + 2 * N + H)),
                   ("mamba/conv_w", (Lm, K, conv),
                    ("clipped", 1.0 / math.sqrt(K)), True),
                   ("mamba/conv_b", (Lm, conv), ("const", 0.0), False),
                   ("mamba/A_log", (Lm, H), ("uniform", A_LOG_MAX), False),
                   ("mamba/dt_bias", (Lm, H), ("const", DT_BIAS), False),
                   ("mamba/D_skip", (Lm, H), ones, False),
                   ("mamba/gate_ln/scale", (Lm, E), ones, False),
                   ("mamba/out_proj", *mat(Lm, E, D))]
    return sorted(leaves)


def model_flops(c: dict, rows: int, seq: int) -> float:
    """Forward and backward operations of one ``[rows, seq]`` batch: six a
    multiplying parameter a token (the tied head and the depthwise conv
    counted, the embedding's gather not); causal attention's two products
    forward and four backward over the visible pairs; and the SSD as its
    recurrence, whatever the chunk: the state's update and its read, H P
    N multiply-adds each a token, forward, and twice that backward. Two
    operations a multiply-add; no recomputation."""
    d = dims(c)
    mult = sum(math.prod(s) for _, s, _, m in leaf_table(c) if m)
    La, Lm = d["kinds"].count("attention"), d["kinds"].count("mamba")
    pairs = seq * (seq + 1) // 2
    attn = 12.0 * d["hd"] * pairs * d["nH"] * La * rows
    ssd = 3 * 4.0 * d["H"] * d["P"] * d["N"] * Lm * rows * seq
    return 6.0 * mult * rows * seq + attn + ssd


def attention_calls(c: dict, rows: int, seq: int) -> list[dict]:
    """The flash-attention calls of one ``[rows, seq]`` batch's forward,
    one an attention layer: causal self-attention over the whole sequence,
    in the keyword shapes of :mod:`bench.yardstick`'s ``flash_*_work``."""
    d = dims(c)
    return [dict(B=rows, Sq=seq, Skv=seq, H=d["nH"], kvH=d["kvH"],
                 hd=d["hd"])] * d["kinds"].count("attention")


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def ssd(u, la, Bm, Cm, chunk: int, carry: bool = True):
    """The recurrence h_t = exp(la_t) h_{t-1} + u_t (x) B_t, y_t = C_t .
    h_t from a zero state, per head. u ``[B, S, H, P]``, la ``[B, S, H]``
    (<= 0), Bm and Cm ``[B, S, N]`` -> y ``[B, S, H, P]``. Chunk by chunk:
    with ``cum`` the inclusive cumulative log decay inside the chunk,
    y_t = sum_{j <= t} (C_t . B_j) exp(cum_t - cum_j) u_j + exp(cum_t)
    C_t . h_in, and the state leaving the chunk exp(cum_C) h_in + sum_j
    exp(cum_C - cum_j) u_j (x) B_j. ``carry`` False zeroes the state
    entering every chunk (a test's probe of what the carried state
    adds)."""
    B, S, H, P = u.shape
    state = u.new_zeros((B, H, P, Bm.shape[-1]))
    ys = []
    for c0 in range(0, S, chunk):
        uc, lc = u[:, c0:c0 + chunk], la[:, c0:c0 + chunk]
        bc, cc = Bm[:, c0:c0 + chunk], Cm[:, c0:c0 + chunk]
        n = uc.shape[1]
        cum = torch.cumsum(lc, dim=1)                          # [B, n, H]
        seen = torch.ones(n, n, dtype=torch.bool, device=u.device).tril()
        gap = cum[:, :, None, :] - cum[:, None, :, :]          # [B, t, j, H]
        decay = torch.exp(gap.masked_fill(~seen[None, :, :, None],
                                          float("-inf")))
        w = torch.einsum("btn,bjn->btj", cc, bc)[..., None] * decay
        y = torch.einsum("btjh,bjhp->bthp", w, uc)
        if carry:
            y = y + torch.einsum("btn,bhpn->bthp", cc, state) \
                * torch.exp(cum)[..., None]
        to_end = torch.exp(cum[:, -1:] - cum)                  # [B, n, H]
        state = torch.exp(cum[:, -1])[:, :, None, None] * state \
            + torch.einsum("bjh,bjhp,bjn->bhpn", to_end, uc, bc)
        ys.append(y)
    return torch.cat(ys, dim=1)


def _conv(x, w, b):
    """Causal depthwise conv of ``x [B, S, C]``: out_t = sum_k w[k] x_{t-k}
    + b (zeros before the first token)."""
    K, C = w.shape
    y = F.conv1d(x.transpose(1, 2), w.flip(0).t()[:, None, :], b,
                 padding=K - 1, groups=C)
    return y[..., :x.shape[1]].transpose(1, 2)


def _mixer_mamba(h, p, j, d):
    B, S, _ = h.shape
    E, H, P, N = d["E"], d["H"], d["P"], d["N"]
    z, xbc, dt = torch.split(h @ p["mamba/in_proj"][j], [E, E + 2 * N, H],
                             dim=-1)
    xbc = F.silu(_conv(xbc, p["mamba/conv_w"][j], p["mamba/conv_b"][j]))
    x, Bm, Cm = torch.split(xbc, [E, N, N], dim=-1)
    dt = F.softplus(dt + p["mamba/dt_bias"][j])                  # [B, S, H]
    la = torch.clamp(-torch.exp(p["mamba/A_log"][j]) * dt,
                     min=LOG_DECAY_FLOOR)
    xh = x.reshape(B, S, H, P)
    y = ssd(xh * dt[..., None], la, Bm, Cm, d["chunk"])
    y = (y + p["mamba/D_skip"][j][:, None] * xh).reshape(B, S, E)
    y = _rmsnorm(y * F.silu(z), p["mamba/gate_ln/scale"][j], d["eps"])
    return y @ p["mamba/out_proj"][j]


def _heads(q, k, v, scale):
    """Causal softmax attention of ``q [B, S, g, hd]`` against one kv head
    ``k, v [B, S, hd]``."""
    S = q.shape[1]
    s = torch.einsum("bqgd,bkd->bgqk", q, k) * scale
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    return torch.einsum("bgqk,bkd->bqgd", torch.softmax(s, dim=-1), v)


def _mixer_attention(h, p, j, d):
    B, S, _ = h.shape
    nH, kvH, hd = d["nH"], d["kvH"], d["hd"]
    g = nH // kvH
    q = (h @ p["attn/wq"][j]).view(B, S, kvH, g, hd)   # q head i reads i // g
    k = (h @ p["attn/wk"][j]).view(B, S, kvH, hd)
    v = (h @ p["attn/wv"][j]).view(B, S, kvH, hd)
    # one kv head at a time, each under checkpointing: the [B, g, S, S]
    # scores of one head's group are all that lives
    out = torch.stack([checkpoint(_heads, q[:, :, i], k[:, :, i], v[:, :, i],
                                  d["att"], use_reentrant=False)
                       for i in range(kvH)], dim=2)
    return out.reshape(B, S, nH * hd) @ p["attn/wo"][j]


def _layer(x, p, i, d):
    j = _index(d)[i]
    mixer = _mixer_mamba if d["kinds"][i] == "mamba" else _mixer_attention
    x = x + d["res"] * mixer(_rmsnorm(x, p["ln_mix/scale"][i], d["eps"]), p,
                             j, d)
    h = _rmsnorm(x, p["ln_mlp/scale"][i], d["eps"])
    mlp = (F.silu(h @ p["mlp/w_gate"][i]) * (h @ p["mlp/w_up"][i])) \
        @ p["mlp/w_down"][i]
    return x + d["res"] * mlp


def hidden(p: dict, tokens, c: dict):
    """``[B, S]`` tokens -> the final-normed hidden states ``[B, S, D]``,
    over ``logits_scaling`` (the tied head's input), each layer under
    activation checkpointing."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d = dims(c)
    x = d["emb"] * p["embed/table"][tokens]
    for i in range(d["L"]):
        x = checkpoint(_layer, x, p, i, d, use_reentrant=False)
    return _rmsnorm(x, p["ln_f/scale"], d["eps"]) / d["logit"]


def logits(p: dict, tokens, c: dict):
    """The full forward's logits ``[B, S, V]``."""
    return hidden(p, tokens, c) @ p["embed/table"].t()


def _nll_sum(h, table, labels):
    z = h @ table.t()
    return torch.sum(torch.logsumexp(z, dim=-1)
                     - z.gather(1, labels[:, None])[:, 0])


def loss(p: dict, tokens, labels, c: dict, chunk: int = 4096):
    """Mean next-token NLL of a batch (``tokens``, ``labels``: ``[B, S]``
    int64) at parameters ``p`` (path -> float32 tensor), every layer and
    every chunk of the output head under activation checkpointing."""
    D = c["hidden_size"]
    h = hidden(p, tokens, c).reshape(-1, D)
    flat = labels.reshape(-1)
    tot = h.new_zeros(())
    for c0 in range(0, flat.shape[0], chunk):
        tot = tot + checkpoint(_nll_sum, h[c0:c0 + chunk], p["embed/table"],
                               flat[c0:c0 + chunk], use_reentrant=False)
    return tot / flat.shape[0]

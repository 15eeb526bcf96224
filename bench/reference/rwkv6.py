"""Plain float32 reference of RWKV-6 ("Finch", ``model_type`` ``rwkv6``) as
the port runs it. Per head (key and value width K):

    y_t = r_t . (S_{t-1} + diag(u * k_t) v_t),
    S_t = diag(exp(w_t)) S_{t-1} + k_t (x) v_t,

with the log decay w_t = max(-exp(w0 + tanh(x_t A) B), -20). The WKV
recurrence is computed exactly by chunks of :data:`CHUNK` steps (the
decay between two steps of a chunk is a product of per-step decays, taken
as the exponential of a difference of cumulative log decays, never above
1), the state carried from chunk to chunk. Plain ``torch`` operations only.

Departures from the published model, all the port's (noted in the
configuration's file): static token-shift weights ``mu_*`` (the published
model mixes them per token), a layer norm over the whole width in place of
the per-head group norm, and the embedding reused as the output head.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

CHUNK = 32
DECAY_LORA = 64
LOG_DECAY_FLOOR = -20.0


def dims(c: dict) -> dict:
    D, K = c["hidden_size"], c["head_size"]
    return dict(D=D, K=K, H=D // K, F=c["intermediate_size"],
                V=c["vocab_size"], L=c["num_hidden_layers"],
                eps=float(c["layer_norm_epsilon"]))


def leaf_table(c: dict) -> list[tuple[str, tuple, tuple, bool]]:
    """``(path, shape, init law, multiplies)`` of every parameter, sorted by
    path (see :func:`bench.reference.phi3.leaf_table`), with the port's
    laws: ``mu_*`` uniform in [0, 1), ``w0`` ones, the decay LoRA's ``wB``
    zeros, ``u`` normal of deviation 0.1."""
    d = dims(c)
    D, H, K, Fd, V, L = (d[k] for k in ("D", "H", "K", "F", "V", "L"))

    def mat(n_in, n_out):
        return (L, n_in, n_out), ("clipped", 1.0 / math.sqrt(n_in)), True

    leaves = [(f"blocks/{n}", *mat(D, D))
              for n in ("Wr", "Wk", "Wv", "Wg", "Wo", "cWr")]
    leaves += [("blocks/cWk", *mat(D, Fd)), ("blocks/cWv", *mat(Fd, D)),
               ("blocks/wA", *mat(D, DECAY_LORA)),
               ("blocks/wB", (L, DECAY_LORA, D), ("const", 0.0), True),
               ("blocks/w0", (L, D), ("const", 1.0), False),
               ("blocks/u", (L, H, K), ("normal", 0.1), False),
               ("embed/table", (V, D), ("normal", 0.02), True),
               ("ln_f/scale", (D,), ("const", 1.0), False),
               ("ln_f/bias", (D,), ("const", 0.0), False)]
    leaves += [(f"blocks/mu_{n}", (L, D), ("uniform", 1.0), False)
               for n in ("r", "k", "v", "w", "g", "ck", "cr")]
    for n in ("ln1", "ln2", "ln_x"):
        leaves += [(f"blocks/{n}/scale", (L, D), ("const", 1.0), False),
                   (f"blocks/{n}/bias", (L, D), ("const", 0.0), False)]
    return sorted(leaves)


def model_flops(c: dict, rows: int, seq: int) -> float:
    """Forward and backward operations of one ``[rows, seq]`` batch: six a
    multiplying parameter a token, and the WKV recurrence's state update
    and read (two products of K x K a head and token, two operations a
    multiply-add) forward and twice that backward."""
    d = dims(c)
    mult = sum(math.prod(s) for _, s, _, m in leaf_table(c) if m)
    wkv = 3 * 4.0 * d["H"] * d["K"] * d["K"] * d["L"]
    return (6.0 * mult + wkv) * rows * seq


def attention_calls(c: dict, rows: int, seq: int) -> list[dict]:
    """No attention: the WKV recurrence mixes the tokens."""
    return []


def _layernorm(x, scale, bias, eps):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def _shift(x):
    """The previous token at each position, zeros before the first."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def wkv(r, k, v, w, u):
    """r, k, v, w: ``[B, S, H, K]`` (w the log decays, <= 0); u ``[H, K]``.
    Returns y ``[B, S, H, K]``: the recurrence above from a zero state,
    chunk by chunk."""
    B, S, H, K = r.shape
    C = CHUNK
    n = -(-S // C)
    pad = n * C - S
    if pad:     # padded steps neither decay the state nor add to it
        r, k, v, w = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, w))
    r, k, v, w = (a.view(B, n, C, H, K).permute(1, 0, 3, 2, 4)
                  for a in (r, k, v, w))             # [n, B, H, C, K]
    cum = torch.cumsum(w, dim=3)                    # to step t
    before = cum - w                                # up to step t - 1
    earlier = torch.ones(C, C, dtype=torch.bool, device=r.device).tril(-1)
    # y_t gets k_j v_j (j < t) decayed by exp(before_t - cum_j) <= 1
    decay = torch.exp((before[..., :, None, :] - cum[..., None, :, :])
                      .masked_fill(~earlier[:, :, None], float("-inf")))
    att = torch.einsum("nbhtk,nbhjk,nbhtjk->nbhtj", r, k, decay)
    y = torch.einsum("nbhtj,nbhjv->nbhtv", att, v)
    y = y + torch.einsum("nbhtk,hk,nbhtk->nbht", r, u, k)[..., None] * v
    # the state entering each chunk, and what a chunk adds to it
    to_end = torch.exp(cum[..., -1:, :] - cum)
    add = torch.einsum("nbhjk,nbhjv->nbhkv", k * to_end, v)
    state = r.new_zeros((B, H, K, K))
    entering = []
    for i in range(n):
        entering.append(state)
        state = torch.exp(cum[i, :, :, -1])[..., None] * state + add[i]
    y = y + torch.einsum("nbhtk,nbhkv->nbhtv", r * torch.exp(before),
                         torch.stack(entering))
    return y.permute(1, 0, 3, 2, 4).reshape(B, n * C, H, K)[:, :S]


def _block(x, p, i, d):
    B, S, D = x.shape
    H, K, eps = d["H"], d["K"], d["eps"]

    def ln(name, t):
        return _layernorm(t, p[f"blocks/{name}/scale"][i],
                          p[f"blocks/{name}/bias"][i], eps)

    a = ln("ln1", x)
    prev = _shift(a)

    def mix(name):
        return a + (prev - a) * p[f"blocks/mu_{name}"][i]

    r = (mix("r") @ p["blocks/Wr"][i]).view(B, S, H, K)
    k = (mix("k") @ p["blocks/Wk"][i]).view(B, S, H, K)
    v = (mix("v") @ p["blocks/Wv"][i]).view(B, S, H, K)
    g = mix("g") @ p["blocks/Wg"][i]
    lora = torch.tanh(mix("w") @ p["blocks/wA"][i]) @ p["blocks/wB"][i]
    w = torch.clamp(-torch.exp(p["blocks/w0"][i] + lora), min=LOG_DECAY_FLOOR)
    y = wkv(r, k, v, w.view(B, S, H, K), p["blocks/u"][i]).reshape(B, S, D)
    x = x + (ln("ln_x", y) * F.silu(g)) @ p["blocks/Wo"][i]
    b = ln("ln2", x)
    prev = _shift(b)
    xk = b + (prev - b) * p["blocks/mu_ck"][i]
    xr = b + (prev - b) * p["blocks/mu_cr"][i]
    kv = torch.square(F.relu(xk @ p["blocks/cWk"][i])) @ p["blocks/cWv"][i]
    return x + torch.sigmoid(xr @ p["blocks/cWr"][i]) * kv


def _nll_sum(h, table, labels):
    logits = h @ table.t()
    return torch.sum(torch.logsumexp(logits, dim=-1)
                     - logits.gather(1, labels[:, None])[:, 0])


def loss(p: dict, tokens, labels, c: dict, chunk: int = 4096):
    """Mean next-token NLL of a batch (``tokens``, ``labels``: ``[B, S]``
    int64) at parameters ``p`` (path -> float32 tensor), every block and
    every chunk of the output head under activation checkpointing."""
    d = dims(c)
    x = p["embed/table"][tokens]
    for i in range(d["L"]):
        x = checkpoint(_block, x, p, i, d, use_reentrant=False)
    h = _layernorm(x, p["ln_f/scale"], p["ln_f/bias"], d["eps"]).reshape(
        -1, d["D"])
    flat = labels.reshape(-1)
    tot = h.new_zeros(())
    for c0 in range(0, flat.shape[0], chunk):
        tot = tot + checkpoint(_nll_sum, h[c0:c0 + chunk], p["embed/table"],
                               flat[c0:c0 + chunk], use_reentrant=False)
    return tot / flat.shape[0]

"""Plain PyTorch attention: the one full-score oracle of the port, and the
flash kernel's plain version (its wrapper runs it for CPU tensors).
:mod:`repro_torch.models.layers` takes it and the causal mask from here,
so the kernel package imports nothing above it."""
from __future__ import annotations

import math

import torch

NEG = -1e30


def _causal_mask(Sq, Skv, window, device):
    """[Sq, Skv] bool: key j is visible to query i (causal with the
    ``Skv - Sq`` prefix offset; ``window > 0`` also hides keys more than
    ``window - 1`` behind)."""
    off = Skv - Sq
    qi = torch.arange(Sq, device=device)[:, None]
    ki = torch.arange(Skv, device=device)[None, :]
    mask = ki <= (qi + off)
    if window > 0:
        mask &= ki > (qi + off - window)
    return mask


def attention_ref(q, k, v, *, causal=True, window=0, return_lse=False):
    """Full (loop-free) attention, as the JAX ``_naive_attention``: float32
    scores from float32 ``q * scale`` and ``k``, softmax, probabilities cast
    to ``v.dtype`` and multiplied with float32 accumulation.

    q [B, Sq, H, hd]; k, v [B, Skv, kvH, hd] (GQA: H % kvH == 0) ->
    o [B, Sq, H, hd] in ``q.dtype``; with ``return_lse`` also the per-row
    float32 log-sum-exp of the scaled, masked scores ``[B, H, Sq]``, the
    flash kernel's second output."""
    B, Sq, H, hd = q.shape
    Skv, kvH = k.shape[1], k.shape[2]
    rep = H // kvH
    kr = torch.repeat_interleave(k, rep, dim=2)
    vr = torch.repeat_interleave(v, rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * (1.0 / math.sqrt(hd)),
                     kr.float())
    if causal:
        s = torch.where(_causal_mask(Sq, Skv, window, q.device), s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(vr.dtype).float(),
                     vr.float()).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1)
    return o

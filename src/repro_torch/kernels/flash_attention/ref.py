"""Plain PyTorch attention, forward and backward: the one full-score oracle
of the port, and the flash kernels' plain versions (their wrappers run them
for CPU tensors). :mod:`repro_torch.models.layers` takes it and the causal
mask from here, so the kernel package imports nothing above it."""
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


def attention_ref(q, k, v, *, causal=True, window=0, return_lse=False,
                  scale=None):
    """Full (loop-free) attention, as the JAX ``_naive_attention``: float32
    scores from float32 ``q * scale`` and ``k``, softmax, probabilities cast
    to ``v.dtype`` and multiplied with float32 accumulation. ``scale``
    defaults to ``1/sqrt(hd)``.

    q [B, Sq, H, hd]; k, v [B, Skv, kvH, hd] (GQA: H % kvH == 0) ->
    o [B, Sq, H, hd] in ``q.dtype``; with ``return_lse`` also the per-row
    float32 log-sum-exp of the scaled, masked scores ``[B, H, Sq]``, the
    flash kernel's second output."""
    B, Sq, H, hd = q.shape
    Skv, kvH = k.shape[1], k.shape[2]
    rep = H // kvH
    kr = torch.repeat_interleave(k, rep, dim=2)
    vr = torch.repeat_interleave(v, rep, dim=2)
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kr.float())
    if causal:
        s = torch.where(_causal_mask(Sq, Skv, window, q.device), s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(vr.dtype).float(),
                     vr.float()).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1)
    return o


def flash_bwd_from_delta(q, k, v, do, lse, delta, *, causal=True, window=0,
                         scale=None):
    """The backward kernels' arithmetic on full ``[S, S]`` float32 scores:
    ``p = exp(s - lse)`` under the forward's masks (``_bwd_mask_and_p``),
    ``dp = do v^T``, ``ds = p * (dp - delta)``, ``dq = scale * ds k``,
    ``dk = scale * ds^T q`` and ``dv = p^T do``, the GQA grads summed over
    the query heads that share a kv head in float32. ``scale`` defaults to
    ``1/sqrt(hd)``.

    q, do [B, Sq, H, hd]; k, v [B, Skv, kvH, hd]; lse, delta [B, H, Sq]
    float32 -> (dq, dk, dv) in the inputs' dtypes."""
    B, Sq, H, hd = q.shape
    Skv, kvH = k.shape[1], k.shape[2]
    rep = H // kvH
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    kr = torch.repeat_interleave(k, rep, dim=2).float()
    vr = torch.repeat_interleave(v, rep, dim=2).float()
    qf, dof = q.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf * scale, kr)
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.where(_causal_mask(Sq, Skv, window, q.device), p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    ds = p * (dp - delta[..., None])
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds, kr)
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(B, Skv, kvH, rep, hd).sum(dim=3)
    dv = dv.reshape(B, Skv, kvH, rep, hd).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_delta(o, do):
    """``delta = rowsum(do * o)`` in float32, ``[B, Sq, H, hd] -> [B, H,
    Sq]`` (the JAX wrapper computes it outside Pallas too)."""
    return torch.sum(do.float() * o.float(), dim=-1).transpose(1, 2)


def flash_bwd_ref(q, k, v, o, lse, do, *, causal=True, window=0,
                  scale=None):
    """Plain attention backward from the forward's ``o`` and ``lse``:
    :func:`flash_delta`, then :func:`flash_bwd_from_delta`. Returns
    ``(dq, dk, dv)``."""
    return flash_bwd_from_delta(q, k, v, do, lse, flash_delta(o, do),
                                causal=causal, window=window, scale=scale)

"""AdamW (optional; the paper's analysis is SGD-only). With ByzSGD each
server replica carries its own (m, v): three times the replica memory."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class AdamWState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor
    count: int


def init(params: torch.Tensor) -> AdamWState:
    return AdamWState(torch.zeros_like(params, dtype=torch.float32),
                      torch.zeros_like(params, dtype=torch.float32), 0)


def update(grads: torch.Tensor, state: AdamWState, params: torch.Tensor,
           lr: float, *, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0):
    """The JAX AdamW step in float32, in place on ``params``, ``m`` and
    ``v`` (``grads`` is scratch). The bias corrections are float32 numbers,
    as the JAX package computes them from its int32 counter."""
    c = state.count + 1
    f32 = np.float32
    g = grads.float()
    m = state.m.mul_(b1).add_(g * (1 - b1))
    v = state.v.mul_(b2).add_(g.square_() * (1 - b2))
    mh = m / float(f32(1) - f32(b1) ** f32(c))
    vh = v / float(f32(1) - f32(b2) ** f32(c))
    step = mh.div_(vh.sqrt_().add_(eps))
    if weight_decay:
        step.add_(params.float(), alpha=weight_decay)
    params.sub_((lr * step).to(params.dtype))
    return params, AdamWState(m, v, c)

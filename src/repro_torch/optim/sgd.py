"""Plain SGD — the paper's optimizer (Eq. 2): theta <- theta - eta_t * G.

Stateless: ByzSGD's server replicas carry no moment state.
"""
from __future__ import annotations

import torch


def init(params):
    del params
    return ()


def update(grads: torch.Tensor, opt_state, params: torch.Tensor, lr: float):
    """``params - lr * grads`` in float32, in place: ``grads`` becomes
    ``lr * grads`` (rounded to float32, as the JAX update's product) and is
    subtracted from ``params``."""
    if params.dtype != torch.float32:
        new = (params.float() - lr * grads.float()).to(params.dtype)
        return params.copy_(new), opt_state
    g = grads if grads.dtype == torch.float32 else grads.float()
    params.sub_(g.mul_(lr))
    return params, opt_state

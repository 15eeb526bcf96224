"""Small reference models of the paper-claim experiments — the port of
``repro.configs.paper_models``.

The paper's testbed models (MNIST_CNN ~80k params, CifarNet ~1.8M) are
CPU-scale; the JAX package mirrors that scale with an MLP over the
synthetic mixture task. Same ``{w0, b0, w1, ...}`` dict and ``[in, out]``
weight layout (applied as ``x @ w + b``), so JAX params load leaf by leaf.
"""
from __future__ import annotations

import math
from functools import partial

import torch


def mlp_init(gen: torch.Generator, dim: int = 64, hidden: int = 128,
             n_classes: int = 10, depth: int = 2, device=None):
    """He-normal weights ``[in, out]`` and zero biases (numbers differ from
    JAX's draws; parity tests load JAX's params instead)."""
    params = {}
    sizes = [dim] + [hidden] * depth + [n_classes]
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = torch.randn((a, b), generator=gen, device=gen.device)
        params[f"w{i}"] = (w * math.sqrt(2.0 / a)).to(device)
        params[f"b{i}"] = torch.zeros((b,), device=device)
    return params


def mlp_apply(params, x):
    n = len(params) // 2
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def mlp_loss(params, batch, l2: float = 1e-4):
    """Cross-entropy + L2 (the paper's Assumption 6 needs a regulariser),
    the L2 term over the leaves in the JAX package's order."""
    x, y = batch
    logits = mlp_apply(params, x)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.mean(torch.gather(logp, -1, y[..., None].long())[..., 0])
    reg = sum(torch.sum(params[k] ** 2) for k in sorted(params))
    return ce + l2 * reg


def mlp_accuracy(params, x, y):
    return torch.mean((torch.argmax(mlp_apply(params, x), dim=-1)
                       == y).float())


def make_mlp_problem(dim: int = 64, hidden: int = 128, n_classes: int = 10,
                     depth: int = 2, l2: float = 1e-4):
    """(init_fn(gen, device), loss_fn(params, batch), accuracy_fn)."""
    init = partial(mlp_init, dim=dim, hidden=hidden, n_classes=n_classes,
                   depth=depth)
    loss = partial(mlp_loss, l2=l2)
    return init, loss, mlp_accuracy

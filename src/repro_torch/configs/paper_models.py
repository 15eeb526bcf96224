"""Small reference models of the paper-claim experiments — the port of
``repro.configs.paper_models``.

The paper's testbed models (MNIST_CNN ~80k params, CifarNet ~1.8M) are
CPU-scale; the JAX package mirrors that scale with an MLP over the
synthetic mixture task. Same ``{w0, b0, w1, ...}`` dict and ``[in, out]``
weight layout (applied as ``x @ w + b``), so JAX params load leaf by leaf.

On a mesh with a 'model' axis (tensor parallelism) a rank holds each
weight's block along the dim that the reference's per-leaf table picks
for it (``repro_torch.core.protocol.model_dims`` with no overrides: the
largest dim that M divides, ties to the first; the biases stay whole), and
the forward and the loss run on those blocks under :func:`mlp_rules`
(:mod:`repro_torch.models.sharding`): a weight split on its output dim is
column-parallel, one split on its input dim row-parallel, a whole one
takes a whole input. The logits end whole on every rank, so the
cross-entropy runs whole.
"""
from __future__ import annotations

import math
from functools import partial

import torch

from ..models import sharding as shr


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
    tp = shr.active()
    if tp is not None:
        return _split_apply(params, x, n, tp)
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def _split_apply(params, x, n: int, tp: shr.Rules):
    """The forward on a rank's blocks: each activation is whole or a block
    of its features (``split``). Column-parallel: a whole input (copied,
    so its gradient sums the ranks' partials) times the output block, plus
    that block of the bias. Row-parallel: a block of the input (scattered
    from a whole one) times the block, the partials summed in rank order,
    plus the whole bias. A whole weight takes a whole input."""
    split = False
    for i in range(n):
        w, b = params[f"w{i}"], params[f"b{i}"]
        d = tp.dim(f"w{i}")
        if d == 1:
            if split:
                x = shr.gather_from_model(x, tp)
            x = shr.copy_to_model(x, tp) @ w + shr.scatter_to_model(b, tp)
            split = True
        elif d == 0:
            if not split:
                x = shr.scatter_to_model(x, tp)
            x = shr.reduce_from_model(x @ w, tp) + b
            split = False
        else:
            if split:
                x = shr.gather_from_model(x, tp)
            x = x @ w + b
            split = False
        if i < n - 1:
            x = torch.relu(x)
    return shr.gather_from_model(x, tp) if split else x


def mlp_loss(params, batch, l2: float = 1e-4):
    """Cross-entropy + L2 (the paper's Assumption 6 needs a regulariser),
    the L2 term over the leaves in the JAX package's order. On a rank's
    blocks (:func:`mlp_rules` installed) the squares of the split leaves'
    blocks are summed over 'model' in rank order and each whole leaf,
    the same on every rank, is counted once."""
    x, y = batch
    logits = mlp_apply(params, x)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.mean(torch.gather(logp, -1, y[..., None].long())[..., 0])
    tp = shr.active()
    if tp is None:
        reg = sum(torch.sum(params[k] ** 2) for k in sorted(params))
        return ce + l2 * reg
    blocks = [k for k in sorted(params) if tp.split(k)]
    reg = sum(torch.sum(params[k] ** 2) for k in sorted(params)
              if k not in blocks)
    if blocks:
        reg = reg + shr.reduce_from_model(
            sum(torch.sum(params[k] ** 2) for k in blocks), tp, "model_loss")
    return ce + l2 * reg


def mlp_rules(split, mesh) -> shr.Rules:
    """The MLP's rule table on ``mesh``: each leaf's 'model' dim by its
    name, from ``split`` (a :class:`~repro_torch.core.protocol.ModelSplit`,
    which also cuts the state's blocks: one layout decides both)."""
    return shr.Rules({path[-1]: {"model": d} for path, d in
                      zip(split.tree.paths, split.dims) if d is not None},
                     mesh)


def is_mlp_tree(tree) -> bool:
    """True when a :class:`~repro_torch.core.simulator.FlatTree` holds the
    leaves of :func:`mlp_init`: top-level ``w{i} [a, b]`` and ``b{i}
    [b]``, each layer's input the width of the one before's output."""
    shapes = {p[0]: tuple(s) for p, s in zip(tree.paths, tree.shapes)
              if len(p) == 1}
    n = len(tree.paths) // 2
    if n == 0 or set(shapes) != {f"{k}{i}" for k in "wb" for i in range(n)} \
            or len(shapes) != len(tree.paths):
        return False
    for i in range(n):
        w = shapes[f"w{i}"]
        if len(w) != 2 or shapes[f"b{i}"] != (w[1],) or \
                (i and w[0] != shapes[f"w{i - 1}"][1]):
            return False
    return True


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

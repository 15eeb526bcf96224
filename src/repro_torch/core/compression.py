"""Gradient compression hooks for the exchange path — the port of
``repro.core.compression`` (beyond the paper).

Composable with MDA because MDA's subset selection needs only pairwise
distances: distances on compressed gradients keep the honest/Byzantine
separation as long as compression is unbiased on honest inputs (random-k)
or sign-consistent (signSGD, Bernstein et al. 2018).

  * :func:`topk_compress`  — keep the k largest-|.| coordinates per leaf;
  * :func:`randk_compress` — keep a random subset, rescaled by 1/frac
    (unbiased);
  * :func:`sign_compress`  — sign(g) * mean|g| per leaf.

A gradient is a tensor or a nested dict of tensors; each operator returns
the same structure in dense form (zeros where dropped). Leaves are visited
in the JAX package's leaf order (sorted keys, depth first).
"""
from __future__ import annotations

import torch


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _map(fn, tree):
    """``fn(i, path, leaf)`` over the leaves in JAX order, same structure."""
    if not isinstance(tree, dict):
        return fn(0, (), tree)
    out: dict = {}
    for i, (path, leaf) in enumerate(_leaves(tree)):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = fn(i, path, leaf)
    return out


def _leaf_topk(leaf: torch.Tensor, frac: float) -> torch.Tensor:
    flat = leaf.reshape(-1)
    k = max(int(flat.numel() * frac), 1)
    thresh = torch.topk(flat.abs(), k).values[-1]
    return torch.where(flat.abs() >= thresh, flat,
                       torch.zeros_like(flat)).reshape(leaf.shape)


def topk_compress(grads, frac: float = 0.01):
    """Keep each leaf's ``max(int(n * frac), 1)`` largest magnitudes (ties
    at the threshold kept, as the reference's ``>=``)."""
    return _map(lambda i, p, leaf: _leaf_topk(leaf, frac), grads)


def randk_compress(grads, gen: torch.Generator | None = None,
                   frac: float = 0.01, *, keep=None):
    """Keep each coordinate with probability ``frac`` and rescale it by
    ``1 / frac``. The masks are drawn from ``gen`` leaf by leaf, or given
    as ``keep`` (a bool mask of the same structure as ``grads``, e.g. one
    replayed from another run)."""
    if (gen is None) == (keep is None):
        raise ValueError("randk_compress needs exactly one of gen / keep")
    masks = dict(_leaves(keep)) if keep is not None else None

    def one(i, path, leaf):
        if masks is not None:
            m = masks[path].to(leaf.device)
        else:
            m = torch.rand(leaf.shape, generator=gen,
                           device=leaf.device) < frac
        return torch.where(m, leaf / frac,
                           torch.zeros_like(leaf)).to(leaf.dtype)

    return _map(one, grads)


def sign_compress(grads):
    """``sign(g) * mean|g|`` per leaf, in the leaf's dtype."""
    return _map(lambda i, p, leaf: (torch.sign(leaf) * leaf.abs().mean()
                                    ).to(leaf.dtype), grads)


COMPRESSORS = {"none": None, "topk": topk_compress, "randk": randk_compress,
               "sign": sign_compress}

"""Aggregate a whole model stack with any registered rule.

The port holds each replica stack as ONE flat tensor ``[.., n, D]`` (n
senders, D = the model's parameters in the JAX package's leaf order, any
leading dims a batch of receivers), where the JAX package walks a pytree leaf
by leaf. The rule's ``tree_mode`` decides the decomposition, as in
``repro.agg.tree``:

  * ``"leafwise"``  — a coordinate-wise rule on the flat stack is exactly the
    rule applied leaf by leaf;
  * ``"selection"`` — distance-based rules take d2 from one Gram of the flat
    stack (the JAX package adds per-leaf partial Grams: equal up to float32
    summation order), select with the rule's ``weights_from_d2`` (exact MDA
    on the subset-diameter kernel), and combine the senders with
    ``torch.matmul``, as the JAX package leaves that product to XLA.

With a batch of receivers every step is one launch for all of them. A nested
dict of ``[n, ...]`` leaves (the JAX layout) is accepted too: it is
flattened in sorted key order, aggregated, and split back. The mesh branch
of the JAX package is protocol work and not ported.
"""
from __future__ import annotations

import torch

from . import dispatch, registry, rules


def _flatten_dict(tree: dict):
    """Nested dict of ``[n, ...]`` leaves -> (``[n, D]``, rebuild function),
    in the JAX package's leaf order (sorted keys)."""
    paths, leaves = [], []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        else:
            paths.append(path)
            leaves.append(t)

    walk(tree, ())
    n = leaves[0].shape[0]
    flat = torch.cat([l.reshape(n, -1).float() for l in leaves], dim=1)

    def rebuild(vec):
        out, off = {}, 0
        for path, l in zip(paths, leaves):
            size = l[0].numel()
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = vec[..., off:off + size].reshape(
                vec.shape[:-1] + l.shape[1:]).to(l.dtype)
            off += size
        return out

    return flat, rebuild


def tree_gram(stack) -> torch.Tensor:
    """``[.., n, n]`` float32 Gram of a flat stack ``[.., n, D]`` (or of a
    nested dict of ``[n, ...]`` leaves, flattened): one kernel launch."""
    if isinstance(stack, dict):
        stack = _flatten_dict(stack)[0]
    return dispatch.gram(stack)


def tree_agg(rule, stack, f: int = 0, *, mask=None, **kw):
    """Aggregate a flat stack ``[n, D]`` -> ``[D]``, a batch of stacks
    ``[B, n, D]`` -> ``[B, D]`` (one launch per kernel for all B), or a
    nested dict of ``[n, ...]`` leaves -> the dict of aggregates.

    ``rule`` is a registry name or an :class:`~.registry.Aggregator`. Extra
    kwargs are filtered against the rule's declared tunables (e.g.
    ``exact_limit`` for MDA). A ``mask`` [n] (host array or tensor)
    restricts aggregation to delivered senders of an unbatched stack."""
    spec = rule if isinstance(rule, registry.Aggregator) else registry.get(rule)
    if isinstance(stack, dict):
        flat, rebuild = _flatten_dict(stack)
        return rebuild(tree_agg(spec, flat, f, mask=mask, **kw))
    if stack.ndim not in (2, 3):
        raise ValueError(f"tree_agg takes a flat [n, D] or [B, n, D] stack; "
                         f"got {tuple(stack.shape)}")
    batched = stack.ndim == 3
    n = stack.shape[-2]
    spec.validate(n, f)
    if mask is not None and batched:
        raise ValueError("a delivery mask applies to one receiver's [n, D] "
                         "stack")
    if spec.tree_mode == "leafwise":
        if mask is not None:
            return spec(stack, f, mask=mask, **kw)
        if not batched:
            return spec._call_unmasked(stack, f, **kw)
        if spec.batches:
            return spec._call_unmasked(stack, f, batched=True, **kw)
        return torch.stack([spec._call_unmasked(s, f, **kw) for s in stack])
    if spec.tree_mode != "selection":
        raise ValueError(
            f"aggregator {spec.name!r} does not support pytree aggregation "
            f"(tree_mode={spec.tree_mode!r})")
    d2 = rules.sqdists_from_gram(tree_gram(stack))
    w = spec.weights_from_d2(d2, f, mask=mask, **spec.filter_kwargs(**kw))
    return torch.matmul(w[..., None, :], stack.float())[..., 0, :].to(
        stack.dtype)


def selection_weights(rule, d2: torch.Tensor, f: int = 0, *, mask=None,
                      **kw) -> torch.Tensor:
    """``[.., n, n]`` distances -> ``[.., n]`` aggregation weights of a
    selection-based rule (MDA, Krum, ...): the entry point for call sites
    that already own the distance matrix, as the protocol's per-server
    quorum weights do (one batch of receivers, one kernel launch)."""
    spec = rule if isinstance(rule, registry.Aggregator) else registry.get(rule)
    if not spec.selection_based or spec.weights_from_d2 is None:
        have = [n for n in registry.names()
                if registry.get(n).selection_based]
        raise ValueError(f"aggregator {spec.name!r} is not selection-based; "
                         f"selection_weights needs one of {have}")
    spec.validate(d2.shape[-1], f)
    return spec.weights_from_d2(d2, f, mask=mask, **spec.filter_kwargs(**kw))

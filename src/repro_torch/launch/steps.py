"""Sharding tables of the train and serve meshes — the port of the first
part of ``repro.launch.steps`` (``train_rules``, ``serve_rules``,
``serve_param_sharding``, ``cache_sharding``, ``_batch_sharding``).

The reference returns ``NamedSharding`` trees that GSPMD lays out. Here
each function returns a per-rank block table: for a logical name, a leaf
or an input, ``{axis: dim}`` — the dim a rank holds its coordinate's
block of on that mesh axis (an axis missing keeps the dim whole) — and
:func:`block` cuts a rank's block of a tensor by such an entry. The
activation tables are :class:`~repro_torch.models.sharding.Rules`, which
the model functions read under
:func:`~repro_torch.models.sharding.sharding_rules`.

Deliberate differences (ROADMAP.md Queue 3):

  * the residual stream (``act_btd``) stays whole on every 'model' rank —
    the reference's ``REPRO_RESID_REPLICATED=1`` layout, without the
    environment switch (the reference's default splits its feature dim
    over 'model');
  * the serving params take the training table's 'model' dims
    (:func:`repro_torch.core.protocol.leaf_spec`, so a checkpoint's block
    is the same cut for both), where the reference's
    ``serve_param_sharding`` takes each leaf's largest divisible dim; the
    ZeRO 'data' dim follows the reference's rule;
  * a name is split only where its dim divides over the axis (GSPMD pads
    the rest), and ``act_ffn`` (the SwiGLU hidden) is named, where GSPMD
    follows ``w_gate`` / ``w_up``.
"""
from __future__ import annotations

import math

import torch

from ..core import protocol
from ..models.sharding import Rules

#: bytes a rank may hold of the serving params after the model split
#: before they are also split over 'data' (the reference's 4 GB)
ZERO_BYTES = 4 * 2**30


def _divides(n: int, size: int) -> bool:
    return size > 1 and n % size == 0 and n >= size


def _act_rules(mesh, cfg, data_axis: str) -> dict:
    M = mesh.size("model")
    D = mesh.size(data_axis)
    r = {"act_btd": {data_axis: 0}}

    def add(name, n, dim):
        r[name] = {data_axis: 0}
        if _divides(n, M):
            r[name]["model"] = dim

    H, kvH, F = protocol.attn_counts(cfg)
    add("logits", cfg.vocab, 2)
    add("act_heads", H, 2)
    add("act_kv_heads", kvH, 2)
    add("act_ffn", F, 2)
    r["kv_cache"] = {data_axis: 0, "model": 2}
    if D == 1:
        for v in r.values():
            v.pop(data_axis, None)
    return r


def train_rules(bmesh, cfg) -> Rules:
    """The rule table of the ('rep', 'fsdp', 'model') train mesh: 'fsdp'
    on the batch dim of each activation (a rank's part of its group's
    rows), 'model' on the head, vocab and SwiGLU-hidden dims where they
    divide."""
    return Rules(_act_rules(bmesh, cfg, "fsdp"), bmesh)


def serve_rules(smesh, cfg) -> Rules:
    """The rule table of the ('data', 'model') serve mesh: 'data' on the
    batch dim, 'model' as in :func:`train_rules`, and the decode cache's
    chunk axis over 'model' (flash-decode merges the chunks' partials)."""
    return Rules(_act_rules(smesh, cfg, "data"), smesh)


def _model_dims(tree, cfg, M: int) -> list:
    return protocol.model_dims(tree, M, protocol.attn_overrides(cfg, M))


def serve_param_sharding(tree, smesh, cfg, itemsize: int = 2) -> list:
    """Per leaf of ``tree`` (a :class:`~repro_torch.core.simulator.
    FlatTree` of the consolidated serving model, in ``itemsize`` bytes a
    value): ``{"model": dim, "data": dim}``. 'model' as the protocol's
    table; when a rank would hold more than :data:`ZERO_BYTES` after the
    model split, 'data' on the leaf's largest other divisible dim (ZeRO:
    gathered at use)."""
    M, Dax = smesh.size("model"), smesh.size("data")
    shard_data = tree.size * itemsize / M > ZERO_BYTES
    out = []
    for shape, m_at in zip(tree.shapes, _model_dims(tree, cfg, M)):
        spec = {} if m_at is None else {"model": m_at}
        if shard_data and len(shape) and math.prod(shape) > 2:
            order = sorted(range(len(shape)), key=lambda i: -shape[i])
            d_at = next((i for i in order
                         if i != m_at and _divides(shape[i], Dax)), None)
            if d_at is not None:
                spec["data"] = d_at
        out.append(spec)
    return out


def cache_sharding(caches, smesh) -> dict:
    """The stacked decode caches' table: k/v ``[L, B, kvH, nc, ck, hd]``
    with the batch over 'data' and the chunk axis over 'model' where they
    divide; the per-row lengths ``[L, B]`` with the batch over 'data'."""
    M, Dax = smesh.size("model"), smesh.size("data")
    k = caches.k.shape
    kv = {}
    if _divides(k[1], Dax):
        kv["data"] = 1
    if _divides(k[3], M):
        kv["model"] = 3
    return {"k": kv, "v": dict(kv),
            "length": {"data": 1} if "data" in kv else {}}


def batch_sharding(name: str, shape, smesh) -> dict:
    """An input's table: 'data' on its batch dim (dim 1 of ``positions``
    ``[3, B, S]``) when it divides, else whole (a B = 1 run stays on every
    rank)."""
    bdim = 1 if name == "positions" and len(shape) == 3 else 0
    return ({"data": bdim} if _divides(shape[bdim], smesh.size("data"))
            else {})


def block(t: torch.Tensor, spec: dict, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (``{axis: dim}``): a
    view, the dim cut into ``mesh.size(axis)`` equal parts."""
    for axis, dim in spec.items():
        n = mesh.size(axis)
        if n > 1:
            b = t.shape[dim] // n
            t = t.narrow(dim, mesh.coord(axis) * b, b)
    return t

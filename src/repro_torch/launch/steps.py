"""Sharding tables and cell builders of the train and serve meshes — the
port of ``repro.launch.steps``: the tables (``train_rules``,
``serve_rules``, ``serve_param_sharding``, ``cache_sharding``,
``_batch_sharding``) and the (arch x shape x mesh) cell builders
(:func:`build_cell`: train, DMC gather, prefill, decode), which give one
rank's step and the rank's blocks of its inputs — ``meta`` tensors for the
dry run (``launch/dryrun.py``, on a :class:`~repro_torch.launch.mesh.
RankView` of the production mesh), or real ones on a mesh of ranks.

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
from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..configs.shapes import ShapeCell
from ..core import protocol
from ..models import sharding as shr
from ..models.registry import get_bundle
from ..models.sharding import Rules
from ..optim.schedules import inverse_linear
from . import mesh as meshlib

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


# ---------------------------------------------------------------------------
# cell builders
# ---------------------------------------------------------------------------

@dataclass
class BuiltCell:
    """A cell's step on one rank: ``fn(*in_specs)`` runs it. ``in_specs``
    are the rank's blocks of the step's inputs — ``meta`` tensors (the dry
    run; the builders' default) or real ones (``device``); ``mesh`` is the
    rank's view (train: ('rep', 'fsdp', 'model'), serve: ('data',
    'model')), whose ``sent`` counts the bytes its collectives send."""
    fn: Callable
    in_specs: tuple
    mesh: Any
    rules: Rules | None
    meta: dict


def _groups(cfg, R: int) -> int:
    """G0: the reference's n_groups policy (``byz_group_divisor``,
    ``byz_group_cap``)."""
    G0 = R // cfg.byz_group_divisor
    return min(G0, cfg.byz_group_cap) if cfg.byz_group_cap else G0


def micro_batches(per_group: int, S: int, K: int) -> int:
    """The reference's micro-batch rule: about 8192 tokens a worker's
    forward and backward, and every micro-batch K-shardable."""
    n_micro = max(1, min(per_group, (per_group * S) // 8192))
    n_micro = min(n_micro, max(per_group // max(K, 1), 1))
    while per_group % n_micro or (per_group // n_micro) % max(K, 1):
        n_micro -= 1
    return n_micro


def _train_state(bundle, pcfg, bmesh, device):
    return protocol.make_init_fn(bundle, pcfg, device=device, mesh=bmesh)(0)


def build_train_cell(arch: str, cell: ShapeCell, prod_mesh, *,
                     engine: str = "naive", exchange_dtype: str = "float32",
                     reduced: bool = False, T: int = 50,
                     depth: int | None = None, pull: str = "median",
                     include_gather: bool = False,
                     device="meta") -> BuiltCell:
    """The protocol's step on this rank of ``prod_mesh`` (its byz view):
    G from ``byz_group_divisor`` / ``byz_group_cap``, the micro-batch rule,
    ``ProtocolConfig.derive(R, R // G0, ...)``; the state's block from
    :func:`~repro_torch.core.protocol.make_init_fn` (on meta: no draw) and
    the rank's part of the batch, ``[(nm,) G/rep, b/K, ...]`` (vlm's
    ``positions`` ``[(nm,) 3, G/rep, b/K, S]``, moved behind the group axis
    before the step)."""
    bundle = get_bundle(arch, reduced=reduced, depth=depth)
    cfg = bundle.cfg
    R = prod_mesh.dp_size
    G0 = _groups(cfg, R)
    B, S = cell.global_batch, cell.seq_len
    per_group = B // G0
    n_micro = micro_batches(per_group, S, R // G0)
    pcfg = protocol.ProtocolConfig.derive(
        R, R // G0, T=T, engine=engine, pull=pull,
        exchange_dtype=exchange_dtype, grad_microbatches=n_micro)
    bmesh = meshlib.make_byz_mesh(prod_mesh, pcfg.n_groups)
    G = pcfg.n_groups
    assert B % G == 0, (arch, cell.name, B, G)
    state = _train_state(bundle, pcfg, bmesh, device)
    rep, K = bmesh.size("rep"), bmesh.size("fsdp")
    nm = pcfg.grad_microbatches

    def part(name, spec):
        if name == "positions" and spec.shape[0] == 3:
            b_m = spec.shape[1] // G // nm
            shape = (3, G // rep, b_m // K) + tuple(spec.shape[2:])
        else:
            b_m = spec.shape[0] // G // nm
            shape = (G // rep, b_m // K) + tuple(spec.shape[1:])
        if nm > 1:
            shape = (nm,) + shape
        return torch.zeros(shape, dtype=spec.dtype, device=device)

    batch = {k: part(k, v)
             for k, v in bundle.batch_specs("train", B, S).items()}
    make = (protocol.make_train_step if include_gather
            else protocol.make_scatter_step)
    raw_step = make(bundle, pcfg, inverse_linear(0.05, 0.01), mesh=bmesh,
                    local_batch=True)

    def step(state, batch):
        if "positions" in batch:
            batch = dict(batch)
            ax = 0 if nm == 1 else 1
            # [.., 3, G, b, S] -> [.., G, 3, b, S]: the group loop maps G
            batch["positions"] = torch.movedim(batch["positions"], ax,
                                               ax + 1)
        return raw_step(state, batch)

    return BuiltCell(fn=step, in_specs=(state, batch), mesh=bmesh,
                     rules=train_rules(bmesh, cfg),
                     meta={"arch": arch, "cell": cell.name, "kind": "train",
                           "G": G, "pcfg": pcfg, "bundle": bundle})


def build_gather_cell(arch: str, cell: ShapeCell, prod_mesh, *,
                      engine: str = "naive", reduced: bool = False,
                      depth: int | None = None,
                      device="meta") -> BuiltCell:
    """The DMC gather step alone (amortised 1/T in the roofline)."""
    bundle = get_bundle(arch, reduced=reduced, depth=depth)
    R = prod_mesh.dp_size
    pcfg = protocol.ProtocolConfig.derive(R, R // _groups(bundle.cfg, R),
                                          engine=engine)
    bmesh = meshlib.make_byz_mesh(prod_mesh, pcfg.n_groups)
    state = _train_state(bundle, pcfg, bmesh, device)
    return BuiltCell(fn=protocol.make_gather_step(pcfg, mesh=bmesh),
                     in_specs=(state,), mesh=bmesh, rules=None,
                     meta={"arch": arch, "cell": cell.name, "kind": "gather",
                           "G": pcfg.n_groups, "pcfg": pcfg,
                           "bundle": bundle})


def serve_params(bundle, smesh, device="meta", params=None):
    """The rank's blocks of the bf16 serving params (``params``, or the
    model's shapes on meta): 'model' by :func:`serve_param_sharding`, ZeRO
    over 'data' past :data:`ZERO_BYTES` (``launch/serve.py``'s cut)."""
    from . import serve
    if params is None:
        params = bundle.meta_params(torch.bfloat16)
        if torch.device(device).type != "meta":
            raise ValueError("serve_params: pass the params to cut on "
                             f"{device}")
    return serve._cut_params(params, smesh, bundle.cfg)


def _serve_cell(kind: str, arch: str, cell: ShapeCell, prod_mesh, *,
                reduced: bool, depth, device, params) -> BuiltCell:
    bundle = get_bundle(arch, reduced=reduced, depth=depth)
    cfg = bundle.cfg
    smesh = meshlib.make_serve_mesh(prod_mesh)
    M = smesh.size("model")
    B, S = cell.global_batch, cell.seq_len
    rules = serve_rules(smesh, cfg)
    p = serve_params(bundle, smesh, device, params)
    batch = {k: block(torch.zeros(v.shape, dtype=v.dtype, device=device),
                      batch_sharding(k, v.shape, smesh), smesh).clone()
             for k, v in bundle.batch_specs(kind, B, S).items()}
    Bl = next(v for k, v in batch.items() if k != "positions").shape[0]
    with shr.sharding_rules(rules):
        caches = bundle.init_caches(Bl, max_len=S, n_chunks=M,
                                    device=device)

    if kind == "prefill":
        def fn(params, batch, caches):
            with shr.sharding_rules(rules):
                return bundle.prefill(params, batch, caches)
        specs = (p, batch, caches)
    else:
        def fn(params, caches, batch):
            with shr.sharding_rules(rules):
                return bundle.decode(params, caches, batch)
        specs = (p, caches, batch)
    return BuiltCell(fn=fn, in_specs=specs, mesh=smesh, rules=rules,
                     meta={"arch": arch, "cell": cell.name, "kind": kind,
                           "bundle": bundle})


def build_prefill_cell(arch: str, cell: ShapeCell, prod_mesh, *,
                       reduced: bool = False, depth: int | None = None,
                       device="meta", params=None) -> BuiltCell:
    """Prefill of the rank's batch rows into its cache: the serving params'
    blocks, the batch over 'data' where it divides, the cache's chunks at
    ``n_chunks = M`` split over 'model'. Real inputs: ``device`` and the
    whole bf16 ``params`` to cut (the batch and cache are zeros)."""
    return _serve_cell("prefill", arch, cell, prod_mesh, reduced=reduced,
                       depth=depth, device=device, params=params)


def build_decode_cell(arch: str, cell: ShapeCell, prod_mesh, *,
                      reduced: bool = False, depth: int | None = None,
                      device="meta", params=None) -> BuiltCell:
    """One decode step of the rank's rows over a cache of ``seq_len``
    positions, as :func:`build_prefill_cell` lays it out."""
    return _serve_cell("decode", arch, cell, prod_mesh, reduced=reduced,
                       depth=depth, device=device, params=params)


def build_cell(arch: str, cell: ShapeCell, prod_mesh, **kw) -> BuiltCell:
    if cell.kind == "train":
        return build_train_cell(arch, cell, prod_mesh, **kw)
    for k in ("engine", "exchange_dtype", "pull"):
        kw.pop(k, None)
    if cell.kind == "prefill":
        return build_prefill_cell(arch, cell, prod_mesh, **kw)
    if cell.kind == "decode":
        return build_decode_cell(arch, cell, prod_mesh, **kw)
    raise ValueError(cell.kind)

"""Distributed ByzSGD — the port of ``repro.core.protocol``.

The paper's server/worker protocol on a ('rep', 'fsdp', 'model') mesh of
``torch.distributed`` ranks (:mod:`repro_torch.launch.mesh`): 'rep' indexes
the ranks that hold the G = n_groups co-located worker+server groups (the
failure domains), G/rep groups a rank; 'model' (tensor parallelism, the
dense and vlm families) gives each rank, for every leaf, its coordinate's
block along the dim the per-leaf table picks (:func:`leaf_spec`,
:class:`ModelSplit`); 'fsdp' splits the rank's flat row of those blocks
into K contiguous column ranges. Without a mesh (or on the ``(1, 1, 1)``
mesh) the G groups share one device and every collective below is the
identity: the single-card engine.

  * scatter step = pull (per-worker masked Median over the delivered server
    replicas, or the §5 round-robin pull with its distance filter)
    -> per-group gradients (a loop over the rank's groups)
    -> the gradient rule (MDA) per server over its delivered quorum, as
       selection weights from one Gram of the gradient stack
    -> local update (the optimizer registry);
  * gather step = DMC: the masked Median across server replicas every T
    steps.

Layout: the replica stack, the pulled view and the gradient stack are each
ONE flat ``[G, P]`` tensor in the JAX package's leaf order
(:class:`~repro_torch.core.simulator.FlatTree`, carried in the state); a
rank holds the block ``[G/rep, P_k]`` of it that :func:`state_layout`
names, so the slice is the same for every model family. A group's model is
a dict of views into its row. The masked pull, the DMC gather and the
gradient aggregation stream by column chunks of at most ``chunk_bytes``;
on a mesh each chunk of the rank's columns is all-gathered over 'rep' into
``[G, c]`` and the coordinate-wise rule runs for the rank's receivers
('fsdp' ranks need nothing from each other there). The steps update the
state's tensors in place (the JAX steps are pure; on one card the replica
stack is the largest tensor there is, and a second copy would not fit at
full width).

Per-group gradients on a mesh: the pulled row is all-gathered over 'fsdp',
each 'fsdp' rank differentiates its contiguous part of the group's batch
rows, weighted by its share of the rows (of the tokens: every row has the
same length), and the parts are summed to column shards in rank order.
Attacks see all G rows of a chunk after the gather (the adversary is
omniscient); a stochastic attack, or random's leaf norm, gathers the whole
stack to every rank and draws at full size from the shared generator, so
every rank's draws are the single card's. The Gram follows
``repro.agg.tree``: an all-to-all over 'rep' puts all G rows of 1/rep of
the rank's columns on each rank, the Gram kernel makes a partial ``[G,
G]`` there, and the partials are gathered and summed in rank order, so
every rank makes the same MDA selection. With 'model' ranks each rank's
partial covers its blocks (a leaf whole on every 'model' rank counts at
coordinate 0 only), and the partials are summed over 'fsdp', 'rep' and
'model' in rank order; the coordinate-wise rules, the attacks on gathered
rows and the update stay on the rank's coordinates. A group's gradient is
then the tensor-parallel loss of its family (:mod:`repro_torch.models.
transformer` and the others) under :func:`repro_torch.launch.steps.
train_rules`, or the paper's MLP's under :func:`repro_torch.configs.
paper_models.mlp_rules`, each 'model' rank differentiating into its
blocks.

Engines: 'naive' all-gathers each gradient chunk over 'rep' and forms the
rank's receivers' weighted sums; 'sharded' forms the partial weighted sums
of the rank's own senders and reduces them over 'rep' (an all-to-all, then
a sum in rank order: the sum over senders keeps its order, where a
``reduce_scatter`` would sum in an order the backend picks). On one device
there are no collectives and both run the same code.

:class:`ProtocolEngine` is the eager counterpart of the JAX fused epochs:
the DMC gather at the T boundary driven by the carried step counter,
per-step metrics written to device buffers, one host transfer per ``run``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple

import gc
import math

import numpy as np
import torch

from .. import agg
from .. import optim as _optim
from ..device import resolve
from ..launch.mesh import AXES, Mesh
from ..models import sharding as _sharding
from ..spans import mark, span
from . import attacks as _attacks
from .attacks import ByzantineSpec, inject_gradients, inject_models
from .quorum import UniformDelivery
from .simulator import FlatTree, coordinatewise_diameter_sum, l2_diameter

# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ProtocolConfig:
    n_groups: int                 # G = n_workers = n_servers (failure domains)
    f_workers: int
    f_servers: int
    q_workers: int
    q_servers: int
    T: int = 50                   # gather every T steps
    grad_microbatches: int = 1    # sequential accumulation per worker step
    engine: str = "sharded"       # 'naive' | 'sharded' (the same on one card)
    pull: str = "median"          # 'median' (async) | 'roundrobin' (sync §5)
    gar: str = "mda"              # worker-gradient rule (selection-based)
    pull_gar: str = "median"      # model rule for the masked worker pull
    gather_gar: str = "median"    # model rule for the DMC gather
    optimizer: str = "sgd"        # repro_torch.optim registry name
    exchange_dtype: str = "float32"
    mda_exact_limit: int = 200_000
    chunk_bytes: int = 256 * 2**20   # column chunk of the streamed passes
    byz: ByzantineSpec = field(default_factory=ByzantineSpec)

    def __post_init__(self):
        # the gradient rule aggregates as convex weights over the groups, so
        # it must be selection-based; the pull/DMC rules must be
        # coordinate-wise with a delivery-mask implementation
        spec = agg.get(self.gar)
        if not spec.selection_based:
            raise ValueError(
                f"protocol gar={self.gar!r} must be selection-based; have "
                f"{[n for n in agg.names() if agg.get(n).selection_based]}")
        spec.validate(self.q_workers, self.f_workers)
        for role in ("pull_gar", "gather_gar"):
            name = getattr(self, role)
            pspec = agg.get(name)
            if pspec.tree_mode != "leafwise" or pspec.masked_fn is None:
                ok = [n for n in agg.names()
                      if agg.get(n).tree_mode == "leafwise"
                      and agg.get(n).masked_fn is not None]
                raise ValueError(f"{role}={name!r} must be a "
                                 f"coordinate-wise rule with traced-mask "
                                 f"support; have {ok}")
            pspec.validate(self.q_servers, self.f_servers)
        if self.optimizer not in _optim.OPTIMIZERS:
            raise ValueError(f"unknown optimizer {self.optimizer!r}; "
                             f"have {sorted(_optim.OPTIMIZERS)}")

    @staticmethod
    def derive(R: int, divisor: int = 1, *, T: int = 50,
               engine: str = "sharded", exchange_dtype: str = "float32",
               grad_microbatches: int = 1, pull: str = "median",
               byz: ByzantineSpec | None = None,
               f_workers: int | None = None, f_servers: int | None = None,
               q_workers: int | None = None, q_servers: int | None = None,
               gar: str = "mda", pull_gar: str = "median",
               gather_gar: str = "median", optimizer: str = "sgd",
               mda_exact_limit: int = 200_000) -> "ProtocolConfig":
        """Resilience parameters for G = R // divisor groups: by default
        f_w = (G-1)//3, f_ps = (G-2)//3 and full-minus-f quorums; explicit
        ``f_*``/``q_*``/GAR overrides lower a declared cluster exactly."""
        G = R // divisor
        f_w = max((G - 1) // 3, 0) if f_workers is None else f_workers
        f_ps = max((G - 2) // 3, 0) if f_servers is None else f_servers
        q_w = (G - f_w) if q_workers is None else q_workers
        q_ps = (max(G - f_ps, min(2 * f_ps + 2, G)) if q_servers is None
                else q_servers)
        return ProtocolConfig(n_groups=G, f_workers=f_w, f_servers=f_ps,
                              q_workers=q_w, q_servers=q_ps, T=T,
                              engine=engine, exchange_dtype=exchange_dtype,
                              grad_microbatches=grad_microbatches, pull=pull,
                              gar=gar, pull_gar=pull_gar,
                              gather_gar=gather_gar, optimizer=optimizer,
                              mda_exact_limit=mda_exact_limit,
                              byz=byz or ByzantineSpec())


class ByzState(NamedTuple):
    params: torch.Tensor          # [G, P] replicas, flat in JAX leaf order
                                  # (a rank's [G/rep, P_k] block on a mesh)
    t: int                        # host step counter
    gen: torch.Generator          # quorums and stochastic attacks
    opt: Any = ()                 # per-replica optimizer state
    tree: FlatTree | None = None  # the model's leaves in the flat layout
    mesh: Mesh | None = None      # the ranks the stack is spread over
    split: "ModelSplit | None" = None   # each leaf's 'model' block (M > 1)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _chunks(P: int, rows: int, itemsize: int, chunk_bytes: int):
    """Column ranges of ``[rows, P]`` passes, each at most ``chunk_bytes``."""
    c = max(1, chunk_bytes // (rows * itemsize))
    return [(c0, min(c0 + c, P)) for c0 in range(0, P, c)]


def _index(batch, i: int):
    """Entry ``i`` of a batch's leading axis (dict or tuple of tensors)."""
    if isinstance(batch, dict):
        return {k: v[i] for k, v in batch.items()}
    return tuple(v[i] for v in batch)


def _rebuild(tree: FlatTree, leaves: list) -> dict:
    """Nested dict of ``leaves`` in the tree's leaf order."""
    out: dict = {}
    for path, leaf in zip(tree.paths, leaves):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


# ---------------------------------------------------------------------------
# the stack on a mesh
# ---------------------------------------------------------------------------


# Explicit per-leaf layout table (Megatron conventions), matched by the
# leaf's final path component, as the reference's. COLUMN-parallel ([..,
# D_in, D_out]): 'model' on the OUTPUT dim. ROW-parallel ([.., D_out
# contraction, D]): 'model' on the contraction dim. Tables: 'model' on the
# vocab. 'fsdp' takes the complementary dim (the port's 'fsdp' splits the
# flat row instead, so only the 'model' dim sets a rank's block).
_COL_LEAVES = {"w_gate", "w_up", "cWk"}
_ROW_LEAVES = {"wo", "w_down", "out_proj", "Wo", "cWv", "wB", "in_proj",
               "Wr", "Wk", "Wv", "Wg", "cWr", "wA"}
_TABLE_LEAVES = {"table", "pos_dec"}
# wq/wk/wv: decided per arch by ``attn_overrides``


def _place(body, picks, M, K):
    """picks: ((axis_name, dim_index), ...) — applied iff divisible."""
    spec = [None] * len(body)
    for name, idx in picks:
        size = M if name == "model" else K
        if size <= 1:
            continue
        i = idx % len(body)
        if spec[i] is None and body[i] % size == 0 and body[i] >= size:
            spec[i] = name
    return spec


def _body_spec(body, M: int, K: int, name: str, overrides) -> list:
    mode = (overrides or {}).get(name)
    if mode == "col" and len(body) >= 2:
        return _place(body, (("model", -1), ("fsdp", -2)), M, K)
    if mode == "row" and len(body) >= 2:
        return _place(body, (("model", -2), ("fsdp", -1)), M, K)
    if name in _COL_LEAVES and len(body) >= 2:
        return _place(body, (("model", -1), ("fsdp", -2)), M, K)
    if name in (_ROW_LEAVES | _TABLE_LEAVES) and len(body) >= 2:
        return _place(body, (("model", -2), ("fsdp", -1)), M, K)
    # fallback: the largest divisible dims; a size-1 axis claims none, and
    # 'model' takes a dim of a 2-D or larger body only
    spec = [None] * len(body)
    order = sorted(range(len(body)), key=lambda i: -body[i])
    m_at = next((i for i in order if body[i] % M == 0 and body[i] >= M
                 and len(body) >= 2), None) if M > 1 else None
    if m_at is not None:
        spec[m_at] = "model"
    k_at = next((i for i in order
                 if i != m_at and body[i] % K == 0 and body[i] >= K), None)
    if k_at is not None and K > 1:
        spec[k_at] = "fsdp"
    return spec


def leaf_spec(shape: tuple, mesh, *, leading_rep: bool = True,
              name: str = "", overrides: dict | None = None) -> tuple:
    """The reference's per-leaf spec of a replica-stacked leaf (``[G,
    *body]`` with ``leading_rep``): for each dim the mesh axis it is split
    over, or ``None``. ``mesh`` needs ``axis_names`` and ``shape``
    (:class:`~repro_torch.launch.mesh.Mesh`)."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    body = list(shape[1:]) if leading_rep else list(shape)
    spec = _body_spec(body, sizes["model"], sizes["fsdp"], name, overrides)
    return ("rep", *spec) if leading_rep else tuple(spec)


def attn_overrides(cfg, mesh) -> dict:
    """``wq`` column-parallel (its head dim over 'model') when the heads
    divide M, and ``wk`` / ``wv`` when the kv heads do; otherwise
    row-parallel (the input dim, as the reference's table for all three).
    The reference keeps all three row-parallel because the column layout
    hit an XLA SPMD SIGFPE (``repro/core/protocol.py:233-243``); a row
    split would cost a reduction of q, k and v in every block (ROADMAP.md
    Queue 3). ``mesh``: a mesh or its 'model' size."""
    M = mesh if isinstance(mesh, int) else mesh.size("model")
    H, kvH, _ = attn_counts(cfg)
    return {"wq": "col" if H % M == 0 else "row",
            "wk": "col" if kvH % M == 0 else "row",
            "wv": "col" if kvH % M == 0 else "row"}


def attn_counts(cfg) -> tuple[int, int, int]:
    """``(heads, kv heads, SwiGLU hidden)`` of the model's attention and
    MLP blocks: the hybrid family's shared block has its own
    (``shared_attn_heads``, ``shared_attn_d_ff``)."""
    if getattr(cfg, "family", None) == "hybrid":
        H = cfg.shared_attn_heads or cfg.n_heads
        return H, H, cfg.shared_attn_d_ff or cfg.d_ff
    return cfg.n_heads, cfg.n_kv_heads, cfg.d_ff


def state_shardings(tree: FlatTree, mesh, overrides: dict | None = None
                    ) -> list:
    """:func:`leaf_spec` of each leaf of a replica-stacked ``tree``; a
    scalar or a leaf of at most 2 values stays whole (``()``)."""
    return [() if len(shape) == 0 or math.prod(shape) <= 2 else
            leaf_spec((1,) + shape, mesh, name=path[-1],
                      overrides=overrides)
            for path, shape in zip(tree.paths, tree.shapes)]


def body_spec(body_shape: tuple, mesh) -> tuple:
    """A replica body's spec (no leading axes): 'model' on the largest
    divisible dim, 'fsdp' on the next."""
    sizes = mesh.sizes
    M, K = sizes["model"], sizes["fsdp"]
    body = list(body_shape)
    spec: list = [None] * len(body)
    order = sorted(range(len(body)), key=lambda i: -body[i])
    m_at = next((i for i in order if body[i] % M == 0 and body[i] >= M),
                None) if M > 1 else None
    if m_at is not None:
        spec[m_at] = "model"
    k_at = next((i for i in order
                 if i != m_at and body[i] % K == 0 and body[i] >= K), None)
    if k_at is not None and K > 1:
        spec[k_at] = "fsdp"
    return tuple(spec)


def _replicaless_spec(shape, mesh) -> tuple:
    """A consolidated (serving) leaf's spec: no 'rep' axis; ('rep',
    'fsdp') together on the fsdp-eligible dim."""
    sizes = mesh.sizes
    M, RK = sizes["model"], sizes["rep"] * sizes["fsdp"]
    body = list(shape)
    spec: list = [None] * len(body)
    order = sorted(range(len(body)), key=lambda i: -body[i])
    m_at = next((i for i in order if body[i] % M == 0 and body[i] >= M), None)
    if m_at is not None:
        spec[m_at] = "model"
    k_at = next((i for i in order
                 if i != m_at and body[i] % RK == 0 and body[i] >= RK), None)
    if k_at is not None:
        spec[k_at] = ("rep", "fsdp")
    return tuple(spec)


def model_dims(tree: FlatTree, M: int, overrides: dict | None) -> list:
    """For each leaf of ``tree`` the dim :func:`leaf_spec` splits over
    'model' at size M (``None``: whole on every 'model' rank)."""
    out = []
    for path, shape in zip(tree.paths, tree.shapes):
        if M == 1 or len(shape) == 0 or math.prod(shape) <= 2:
            out.append(None)
            continue
        spec = _body_spec(list(shape), M, 1, path[-1], overrides)
        out.append(spec.index("model") if "model" in spec else None)
    return out


#: the roots of the layer stacks (leaves ``[L, ...]``) of every family
STACKS = ("blocks", "mamba", "enc_blocks", "dec_blocks")


class ModelSplit:
    """The 'model' axis's cut of a model's flat layout: for each leaf of
    ``tree`` the dim split over M ranks (``dims``), and this rank's
    coordinate m. ``local`` is the tree of the rank's blocks, whose flat
    row (``local.size`` values) is what 'rep' and 'fsdp' lay out."""

    def __init__(self, tree: FlatTree, dims: list, M: int, m: int):
        self.tree, self.dims, self.M, self.m = tree, list(dims), M, m
        for path, d in zip(tree.paths, self.dims):
            if d == 0 and path[0] in STACKS:
                raise NotImplementedError(
                    f"{'/'.join(path)}: the 'model' axis would split the "
                    "layer stack")
        self.local = FlatTree(tree.paths, [
            s if d is None else s[:d] + (s[d] // M,) + s[d + 1:]
            for s, d in zip(tree.shapes, self.dims)])

    def block(self, leaf: torch.Tensor, i: int, m: int | None = None,
              lead: int = 0) -> torch.Tensor:
        """Leaf ``i``'s block at coordinate ``m`` (this rank's by
        default) of ``leaf [*lead dims, *shape]`` (a view)."""
        d = self.dims[i]
        if d is None:
            return leaf
        n = self.local.shapes[i][d]
        return leaf.narrow(lead + d, (self.m if m is None else m) * n, n)

    def cut(self, flat: torch.Tensor, m: int | None = None) -> torch.Tensor:
        """``[..., P]`` whole rows -> ``[..., P_m]``, the blocks at
        coordinate ``m`` (this rank's by default)."""
        pre = tuple(flat.shape[:-1])
        parts = [self.block(flat[..., off:off + size].reshape(pre + shape),
                            i, m, len(pre)).reshape(pre + (-1,))
                 for i, (shape, (off, size)) in enumerate(
                     zip(self.tree.shapes, self.tree.spans()))]
        return torch.cat(parts, dim=-1)

    def join(self, blocks: torch.Tensor) -> torch.Tensor:
        """``[M, ..., P_m]`` (every coordinate's rows) -> ``[..., P]``."""
        pre = tuple(blocks.shape[1:-1])
        parts = []
        for i, (shape, (off, size)) in enumerate(
                zip(self.local.shapes, self.local.spans())):
            seg = blocks[..., off:off + size]
            d = self.dims[i]
            if d is None:
                parts.append(seg[0])
                continue
            seg = seg.reshape((self.M,) + pre + shape)
            parts.append(torch.cat(list(seg.unbind(0)), dim=len(pre) + d)
                         .reshape(pre + (-1,)))
        return torch.cat(parts, dim=-1)

    def owned(self, device=None) -> torch.Tensor | None:
        """``[P_m]`` float mask of the columns this rank counts in sums
        over every coordinate (a Gram, a norm): a leaf whole on every
        'model' rank counts at coordinate 0 only. ``None`` at m = 0."""
        if self.m == 0:
            return None
        mask = torch.ones(self.local.size, device=device)
        for d, (off, size) in zip(self.dims, self.local.spans()):
            if d is None:
                mask[off:off + size] = 0
        return mask


def model_split(cfg, tree: FlatTree, mesh: Mesh | None) -> ModelSplit | None:
    """The :class:`ModelSplit` of a model of config ``cfg`` on ``mesh``
    (``None`` without a 'model' axis). Every family of
    :data:`repro_torch.models.registry.MODEL_AXIS_FAMILIES` takes one,
    with its attention's overrides; the paper's MLP problem (a
    :class:`ProblemBundle`'s config, whose tree is an MLP's) takes the
    table's fallback for every leaf, as the reference's ``leaf_spec``
    places it."""
    if mesh is None or mesh.size("model") == 1:
        return None
    from ..models.registry import check_model_axis
    M = mesh.size("model")
    check_model_axis(cfg, M)
    overrides = None
    if isinstance(cfg, _ProblemCfg):
        from ..configs.paper_models import is_mlp_tree
        if not is_mlp_tree(tree):
            raise NotImplementedError(
                f"model = {M} for a problem whose leaves "
                f"{['/'.join(p) for p in tree.paths]} are not an MLP's: the "
                "'model' axis runs a problem through the MLP's split form "
                "(configs.paper_models.make_mlp_problem) only")
    else:
        overrides = attn_overrides(cfg, M)
    return ModelSplit(tree, model_dims(tree, M, overrides), M,
                      mesh.coord("model"))


class Layout(NamedTuple):
    """A rank's block of the flat ``[G, P]`` stack: replica rows ``[r0,
    r1)``, columns ``[k0, k1)``, and the K + 1 column bounds of every 'fsdp'
    rank's range."""
    rows: tuple[int, int]
    cols: tuple[int, int]
    bounds: tuple[int, ...]


def state_layout(mesh: Mesh | None, n_groups: int, P: int) -> Layout:
    """Rows and columns of this rank's block: G/rep consecutive replica
    rows at its 'rep' coordinate, and the k-th of K near-equal contiguous
    column ranges of the flat ``P`` at its 'fsdp' coordinate k — with a
    'model' axis, ``P`` is the size of the rank's flat row of blocks
    (``ModelSplit.local``). A layout, never a semantic: the rules are
    coordinate-wise or read distances, so where a column lives changes no
    result beyond summation order. The per-leaf table
    (:func:`leaf_spec`) decides the 'model' blocks only: on the flat
    layout a leaf is a column range, so 'rep' and 'fsdp' have nothing to
    decide per leaf. A rank that sits the mesh out (``Mesh.member``
    false) holds every row and no column: ``[G, 0]``."""
    sizes = mesh.sizes if mesh is not None else {}
    rep, K = sizes.get("rep", 1), sizes.get("fsdp", 1)
    if n_groups % rep:
        raise ValueError(f"rep={rep} must divide n_groups={n_groups}")
    bounds = tuple(i * P // K for i in range(K + 1))
    if mesh is not None and not mesh.member:
        return Layout((0, n_groups), (0, 0), bounds)
    gl = n_groups // rep
    r = mesh.coord("rep") if rep > 1 else 0
    k = mesh.coord("fsdp") if K > 1 else 0
    return Layout((r * gl, (r + 1) * gl), (bounds[k], bounds[k + 1]), bounds)


_SINGLE = Mesh(AXES, (1, 1, 1))


class _Ranks:
    """One rank's view of a ``[G, P]`` stack on ``mesh``: the collectives
    the steps make, each counted on the mesh under a tag. On the ``(1, 1,
    1)`` mesh (``trivial``) every one is the identity on the whole
    stack. With a 'model' axis ``split`` (:class:`ModelSplit`) names the
    rank's blocks, and P is the whole model's size."""

    def __init__(self, mesh: Mesh | None, n_groups: int, P: int,
                 chunk_bytes: int, split: ModelSplit | None = None):
        self.mesh = mesh or _SINGLE
        self.G = n_groups
        self.chunk_bytes = chunk_bytes
        self.M = self.mesh.size("model")
        if self.M > 1 and split is None:
            raise ValueError(
                f"a 'model' axis of {self.M} needs the model's per-leaf "
                "split (protocol.model_split of the model's config and "
                "tree on the mesh)")
        self.split = split if self.M > 1 else None
        self.P = P
        self.lay = state_layout(self.mesh, self.G,
                                split.local.size if self.split else P)
        self.rep, self.K = self.mesh.size("rep"), self.mesh.size("fsdp")
        self.trivial = self.rep == self.K == self.M == 1
        self.r0, self.r1 = self.lay.rows
        self.k0, self.k1 = self.lay.cols

    @property
    def local_tree(self) -> FlatTree | None:
        """The tree of the rank's flat row (its 'model' blocks), ``None``
        without a 'model' axis (the state's own tree)."""
        return self.split.local if self.split else None

    def owned(self, device) -> torch.Tensor | None:
        """The rank's columns' weights in a sum over every column: 0 on a
        leaf whole on every 'model' rank away from coordinate 0, else 1
        (``None``: all 1)."""
        if self.split is None or self.split.m == 0:
            return None
        return self.split.owned(device)[self.k0:self.k1]

    def to_local(self, whole: torch.Tensor) -> torch.Tensor:
        """``[n, P]`` whole rows -> the rank's columns ``[n, P_k]``."""
        if self.split is not None:
            whole = self.split.cut(whole)
        return whole[:, self.k0:self.k1]

    # -- rows over 'rep' ----------------------------------------------------
    def rows(self, local: torch.Tensor, tag: str, inject=None, tree=None):
        """``(chunks, rows_of)``: ``rows_of(c0, c1)`` is ``[G, c1 - c0]``,
        every replica's entries at the rank's columns ``c0:c1`` (local
        indices), with ``inject(stack, tree)`` (an attack) applied. Chunks
        of the rank's columns are gathered over 'rep' one at a time; a
        stochastic attack, or any attack on the single card, runs once on
        the whole stack (gathered whole on a mesh), eagerly, so its draws
        come where the single card's do."""
        pk = local.shape[1]
        coordinatewise = inject is not None and inject.coordinatewise
        if self.trivial or (inject is not None and not coordinatewise):
            full = local
            if inject is not None:
                full = inject(local if self.trivial
                              else self.gather_all(local, "attack"), tree)
                if not self.trivial:
                    full = self.to_local(full)
            return [(0, pk)], lambda c0, c1: full[:, c0:c1]

        def rows_of(c0, c1):
            x = self.mesh.all_gather(local[:, c0:c1], "rep", tag)
            return inject(x, None) if inject is not None else x

        return (_chunks(pk, self.G, local.element_size(), self.chunk_bytes),
                rows_of)

    def rows_sum(self, partial: torch.Tensor, tag: str) -> torch.Tensor:
        """``[G, c]`` partials (rows in receiver order) -> this rank's
        receivers' ``[G/rep, c]``: the partials of every 'rep' rank summed
        in rank order, in float32."""
        recv = self.mesh.all_to_all(partial, "rep", tag)
        recv = recv.view(self.rep, -1, partial.shape[1])
        out = recv[0].float()
        for j in range(1, self.rep):
            out += recv[j]
        return out

    # -- columns over 'fsdp' ------------------------------------------------
    def _padded(self, x: torch.Tensor, bounds, width: int) -> torch.Tensor:
        """``[K, n, width]``: block k holds ``x``'s columns ``bounds[k]:
        bounds[k+1]``, zero-padded."""
        out = x.new_zeros((self.K, x.shape[0], width))
        for k in range(self.K):
            a, b = bounds[k], bounds[k + 1]
            out[k, :, :b - a] = x[:, a:b]
        return out

    def cols_gather(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        """``[n, P_k]`` on each 'fsdp' rank -> ``[n, P]``."""
        if self.K == 1:
            return x
        b = self.lay.bounds
        width = max(b[i + 1] - b[i] for i in range(self.K))
        pad = x.new_zeros((x.shape[0], width))
        pad[:, :x.shape[1]] = x
        blocks = self.mesh.all_gather(pad, "fsdp", tag).view(
            self.K, x.shape[0], width)
        return torch.cat([blocks[k, :, :b[k + 1] - b[k]]
                          for k in range(self.K)], dim=1)

    def cols_sum(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        """``[n, P]`` on each 'fsdp' rank -> this rank's columns of their
        sum, added in rank order (float32)."""
        if self.K == 1:
            return x.float()
        b = self.lay.bounds
        width = max(b[i + 1] - b[i] for i in range(self.K))
        recv = self.mesh.all_to_all(
            self._padded(x, b, width).view(-1, width), "fsdp", tag)
        recv = recv.view(self.K, x.shape[0], width)[..., :self.k1 - self.k0]
        out = recv[0].float()
        for j in range(1, self.K):
            out += recv[j]
        return out

    def scalars_sum(self, v: torch.Tensor, tag: str) -> torch.Tensor:
        """Per-row partial sums ``[n]`` over this rank's columns -> the sums
        over all columns, added in 'fsdp' then 'model' rank order (a
        caller weighs its partials by :meth:`owned`)."""
        for axis, n in (("fsdp", self.K), ("model", self.M)):
            if n > 1:
                parts = self.mesh.all_gather(v[None], axis, tag)
                v = parts[0].clone()
                for j in range(1, n):
                    v += parts[j]
        return v

    # -- whole stacks -------------------------------------------------------
    def model_join(self, rows: torch.Tensor, tag: str) -> torch.Tensor:
        """``[n, P_m]`` (the rank's flat row of 'model' blocks) -> ``[n,
        P]``, gathered over 'model' and joined leaf by leaf."""
        if self.split is None:
            return rows
        return self.split.join(self.mesh.all_gather(rows[None], "model",
                                                    tag))

    def gather_all(self, local: torch.Tensor, tag: str) -> torch.Tensor:
        """The whole ``[G, P]`` stack on every rank (attacks, metrics,
        checkpoints at test scale)."""
        return self.model_join(
            self.cols_gather(self.mesh.all_gather(local, "rep", tag), tag),
            tag)

    def row(self, local: torch.Tensor, g: int, tag: str) -> torch.Tensor:
        """Replica row ``g`` whole (``[P]``) on every rank."""
        if self.trivial:
            return local[g]
        gl = self.r1 - self.r0
        owner = g // gl
        x = (local[g - self.r0] if self.r0 <= g < self.r1
             else local.new_empty(local.shape[1]))
        if self.rep > 1:
            self.mesh.broadcast(x, "rep", tag, src=owner)
        return self.model_join(self.cols_gather(x[None], tag), tag)[0]

    def gram(self, local: torch.Tensor) -> torch.Tensor:
        """``[G, G]`` float32 Gram of the whole gradient stack, the same on
        every rank. Each column chunk of the rank's block is spread by an
        all-to-all over 'rep' (rank j gets every rank's rows of the chunk's
        j-th part: all G rows, zero-padded), the Gram kernel adds the
        partial of each, and the ranks' partials are gathered and summed in
        rank order."""
        if self.trivial:
            return agg.tree_gram(local)
        gl, pk = local.shape
        own = self.owned(local.device)
        total = torch.zeros((self.G, self.G), dtype=torch.float32,
                            device=local.device)
        for c0, c1 in _chunks(pk, self.G, 4, self.chunk_bytes):
            width = -(-(c1 - c0) // self.rep)
            bounds = [min(c0 + j * width, c1) for j in range(self.rep + 1)]
            send = local.new_zeros((self.rep, gl, width))
            for j in range(self.rep):
                a, b = bounds[j], bounds[j + 1]
                send[j, :, :b - a] = (local[:, a:b] if own is None
                                      else local[:, a:b] * own[a:b])
            recv = self.mesh.all_to_all(send.view(-1, width), "rep", "gram")
            total += agg.tree_gram(recv.float())
        parts = self.mesh.all_gather(total[None], "fsdp", "gram")
        parts = self.mesh.all_gather(parts, "rep", "gram")
        parts = self.mesh.all_gather(parts, "model", "gram")
        out = parts[0].clone()
        for j in range(1, parts.shape[0]):
            out += parts[j]
        return out

    # -- batches ------------------------------------------------------------
    def batch_part(self, batch, n_micro: int, local: bool = False):
        """``(part, share)``: this rank's groups' rows of the batch (leaves
        ``[G, B, ...]``, or ``[n_micro, G, B, ...]``) and its contiguous
        'fsdp' part of each group's B rows, with that part's share of the
        rows. A ``local`` batch is that part already (leaves ``[(n_micro,)
        G/rep, B/K, ...]``, as the cell builders pass it)."""
        if self.trivial:
            return batch, 1.0
        if local:
            return batch, 1.0 / self.K
        ga = 1 if n_micro > 1 else 0
        leaves = batch.values() if isinstance(batch, dict) else batch
        B = next(iter(leaves)).shape[ga + 1]
        k = self.mesh.coord("fsdp") if self.K > 1 else 0
        b0, b1 = k * B // self.K, (k + 1) * B // self.K

        def cut(v):
            return v.narrow(ga, self.r0, self.r1 - self.r0).narrow(
                ga + 1, b0, b1 - b0)

        part = ({n: cut(v) for n, v in batch.items()}
                if isinstance(batch, dict) else tuple(cut(v) for v in batch))
        return part, (b1 - b0) / B


class _Attack:
    """An attack on a stack, ``(stack, tree) -> stack``: gradients or
    models, with the configuration's spec and the run's generator."""

    def __init__(self, kind: str, spec: ByzantineSpec, gen):
        name = spec.worker_attack if kind == "grads" else spec.server_attack
        table = (_attacks.GRADIENT_ATTACKS if kind == "grads"
                 else _attacks.MODEL_ATTACKS)
        self.kind, self.spec, self.gen = kind, spec, gen
        self.coordinatewise = table[name] not in _attacks._STOCHASTIC

    def __call__(self, stack, tree):
        inject = inject_gradients if self.kind == "grads" else inject_models
        return inject(stack, self.spec, self.gen, tree=tree)


# ---------------------------------------------------------------------------
# protocol ops
# ---------------------------------------------------------------------------


def _rule_batched(spec, stack: torch.Tensor, f: int) -> torch.Tensor:
    """The coordinate-wise ``spec`` over each receiver's ``[n, c]`` stack of
    ``[B, n, c]``: one launch for all B where the rule batches. The count n
    is a delivered quorum's, not a declared one, so it is not validated
    against f (the configuration's quorums were, in ``ProtocolConfig``)."""
    if spec.batches:
        return spec._call_unmasked(stack, f, batched=True)
    return torch.stack([spec._call_unmasked(x, f) for x in stack])


def masked_pull(params: torch.Tensor, masks: torch.Tensor,
                cfg: ProtocolConfig, rule=None, out=None) -> torch.Tensor:
    """Per-receiver masked aggregation over the replica axis.

    params ``[G, P]``; masks ``[G_recv, G_send]`` bool. Returns ``[G_recv,
    P]`` (written into ``out`` when given, which may be ``params`` itself)
    — receiver g's aggregate of its delivered replicas under ``rule``
    (default ``cfg.pull_gar``, the paper's Median; the DMC gather passes
    ``cfg.gather_gar``). The stack streams by column chunks of at most
    ``cfg.chunk_bytes``; the rules are coordinate-wise, so the rule over the
    delivered rows is the masked rule.

    A mask's count may differ per receiver, as the JAX ``masked_pull``
    allows: a trace repeats a sender to fill a quorum that faults starved,
    so that receiver delivers one replica fewer. The receivers are grouped
    by count, one launch of the rule per count per chunk; every group's rows
    of a chunk are gathered before any output of that chunk is written, so
    ``out`` may alias ``params``. With one count the route is one gather and
    one launch per chunk."""
    spec = agg.get(rule or cfg.pull_gar)
    G_recv = masks.shape[0]
    P = params.shape[1]
    counts = masks.sum(dim=1).tolist()
    mark("byzsgd.host_sync")
    if min(counts) < 1:
        raise ValueError(f"masked_pull needs a delivered replica per "
                         f"receiver; got counts {counts}")
    if out is None:
        out = torch.empty((G_recv, P), dtype=params.dtype,
                          device=params.device)
    order = torch.argsort((~masks).to(torch.int8), dim=1, stable=True)
    if len(set(counts)) == 1:
        groups = [(None, order[:, :counts[0]])]
    else:
        groups = []
        for q in sorted(set(counts)):
            rows = [g for g, c in enumerate(counts) if c == q]
            r = torch.as_tensor(rows, device=masks.device)
            groups.append((r, order[r, :q]))
    for c0, c1 in _chunks(P, sum(counts), 4, cfg.chunk_bytes):
        stacks = [params[:, c0:c1][idx].float() for _, idx in groups]
        for (rows, _), stack in zip(groups, stacks):   # [G_q, q, c]
            res = _rule_batched(spec, stack, cfg.f_servers)
            if rows is None:
                out[:, c0:c1] = res
            else:
                out[rows, c0:c1] = res.to(out.dtype)
    return out


def quorum_weights(d2: torch.Tensor, quorum_idx: torch.Tensor, f: int,
                   cfg: ProtocolConfig) -> torch.Tensor:
    """Per-server selection weights of the configured gradient rule.

    d2 ``[G, G]`` squared distances; quorum_idx ``[G_recv, q]`` delivered
    worker indices per server. Each server's ``[q, q]`` block of d2 goes
    through the rule's ``weights_from_d2`` (rows sum to 1), all servers in
    one batch, and the weights scatter back to ``[G_recv, G_send]``.

    A sender repeated in a row (a trace's padded quorum) takes the weight of
    its last occurrence, as the JAX ``.at[idx].set(w)`` does: every
    occurrence is given that weight before the scatter, so the scatter's
    write order (undefined on CUDA for repeated indices) cannot matter."""
    G = d2.shape[0]
    idx = quorum_idx.long()
    sub = d2[idx[:, :, None], idx[:, None, :]]              # [G_recv, q, q]
    w = agg.selection_weights(cfg.gar, sub, f,
                              exact_limit=cfg.mda_exact_limit).float()
    q = idx.shape[1]
    pos = torch.arange(q, device=idx.device)
    same = idx[:, :, None] == idx[:, None, :]               # [G_recv, q, q]
    last = torch.where(same, pos, -1).amax(dim=2)           # [G_recv, q]
    return torch.zeros((idx.shape[0], G), dtype=torch.float32,
                       device=d2.device).scatter_(1, idx, w.gather(1, last))


def aggregate_gradients(grads: torch.Tensor, weights: torch.Tensor,
                        cfg: ProtocolConfig, out=None) -> torch.Tensor:
    """``G_hat[s] = sum_w weights[s, w] * grads[w]`` over column chunks, in
    ``cfg.exchange_dtype``: a ``[G, G] x [G, c]`` ``torch.matmul`` per chunk
    (the JAX package leaves this product to XLA). ``out`` may be ``grads``
    itself: each chunk is read whole before it is overwritten."""
    dt = _dtype(cfg.exchange_dtype)
    w = weights.to(dt)
    G, P = grads.shape
    if out is None:
        out = torch.empty((w.shape[0], P), dtype=dt, device=grads.device)
    for c0, c1 in _chunks(P, G, grads.element_size(), cfg.chunk_bytes):
        out[:, c0:c1] = torch.matmul(w, grads[:, c0:c1].to(dt))
    return out


def group_grads(bundle, tree: FlatTree, pulled: torch.Tensor, batch,
                n_micro: int, out: torch.Tensor) -> torch.Tensor:
    """Per-group worker gradients into ``out [G, P]``: group g's loss on its
    batch share at its pulled model (a dict of views into ``pulled[g]``),
    differentiated leaf by leaf and written into row g in the flat layout.
    A loop over the groups (the JAX ``vmap``), so one group's activations
    are alive at a time. With ``n_micro > 1`` the batch has a leading micro
    axis and the gradients average over it in float32."""
    for g in range(pulled.shape[0]):
        leaves = [v.detach().requires_grad_()
                  for v in tree.leaves(tree.unflatten(pulled[g]))]
        params = _rebuild(tree, leaves)
        for m in range(n_micro):
            mb = _index(batch, m) if n_micro > 1 else batch
            with span("byzsgd.model"):
                loss = bundle.loss(params, _index(mb, g))
                gs = torch.autograd.grad(loss, leaves, allow_unused=True)
            with span("byzsgd.flatten"):
                for (off, size), gl in zip(tree.spans(), gs):
                    dst = out[g, off:off + size]
                    if gl is None:
                        if m == 0:
                            dst.zero_()
                        continue
                    gl = gl.reshape(-1)
                    if n_micro == 1:
                        dst.copy_(gl)
                    elif m == 0:
                        dst.copy_(gl.float() / n_micro)
                    else:
                        dst.add_(gl.float() / n_micro)
            del loss, gs
    return out


def _roundrobin_pull(rows, own: torch.Tensor, t: int, eta: float,
                     cfg: ProtocolConfig, out: torch.Tensor, ranks: _Ranks):
    """The §5 synchronous pull: worker g takes replica ``(g + t + 1) % G``
    and keeps it iff its squared distance to its own replica is within the
    Outliers bound anchored locally, else its own replica. ``rows`` is
    ``_Ranks.rows``' ``(chunks, rows_of)`` over the (attacked) replicas;
    ``own`` the rank's own rows; the distances add over 'fsdp' ranks."""
    G = cfg.n_groups
    Gl, pk = own.shape
    idx = (torch.arange(G, device=own.device) + t + 1) % G
    mine = idx[ranks.r0:ranks.r1]
    chunks, rows_of = rows
    if len(chunks) == 1:
        chunks = _chunks(pk, 2 * G, 4, cfg.chunk_bytes)
    d2g = torch.zeros(Gl, dtype=torch.float32, device=own.device)
    n2g = torch.zeros(Gl, dtype=torch.float32, device=own.device)
    wt = ranks.owned(own.device)
    for c0, c1 in chunks:
        ow = own[:, c0:c1].float()
        d2 = (rows_of(c0, c1)[mine].float() - ow) ** 2
        n2 = ow ** 2
        if wt is not None:
            d2, n2 = d2 * wt[c0:c1], n2 * wt[c0:c1]
        d2g += torch.sum(d2, dim=1)
        n2g += torch.sum(n2, dim=1)
    d2g = ranks.scalars_sum(d2g, "pull")
    n2g = ranks.scalars_sum(n2g, "pull")
    growth = ((3.0 * cfg.T + 2.0) * (G - cfg.f_workers)
              / (4.0 * max(cfg.f_workers, 1)))
    eta_t = torch.tensor(eta, dtype=torch.float32, device=own.device)
    bound2 = (eta_t * growth) ** 2 * n2g + 1e-6
    ok = (d2g <= bound2)[:, None]
    for c0, c1 in chunks:
        out[:, c0:c1] = torch.where(ok, rows_of(c0, c1)[mine],
                                    own[:, c0:c1])
    return out


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def make_init_fn(bundle, pcfg: ProtocolConfig, device=None, mesh=None):
    """Returns ``init(seed) -> ByzState``: one model drawn from a generator
    seeded with ``seed``, cast to the bundle's ``param_dtype`` and
    replicated into the ``[G, P]`` stack (one copy, leaf by leaf; on a
    ``mesh`` every rank draws the whole model and keeps its block: its
    'model' blocks of each leaf, then its 'fsdp' columns), a fresh run
    generator (``seed + 1``, the same stream on every rank) and the
    optimizer's per-replica state.

    On ``device="meta"`` nothing is drawn (the reference's
    ``jax.eval_shape(init, ...)``): the tree comes from the family's init
    under a fake-tensor mode (:meth:`~repro_torch.models.registry.
    ModelBundle.meta_params`), the rank's block and the optimizer state are
    meta tensors, and the run's generator is a CPU one, so the quorum
    tables are drawn on the host and read there as on the card."""
    dev = resolve(device)
    pdt = _dtype(bundle.cfg.param_dtype)
    opt = _optim.get(pcfg.optimizer)

    def init(seed: int) -> ByzState:
        meta = dev.type == "meta"
        p0 = None if meta else bundle.init(
            torch.Generator(device=dev).manual_seed(seed))
        tree = FlatTree.from_params(bundle.meta_params() if meta else p0)
        split = model_split(bundle.cfg, tree, mesh)
        local = split.local if split else tree
        (r0, r1), (k0, k1), _ = state_layout(mesh, pcfg.n_groups, local.size)
        params = torch.empty((r1 - r0, k1 - k0), dtype=pdt, device=dev)
        for i, (leaf, (off, size)) in enumerate(
                zip(tree.leaves(p0) if p0 is not None else [],
                    local.spans())):
            a, b = max(off, k0), min(off + size, k1)
            if a < b:
                if split:
                    leaf = split.block(leaf, i)
                params[:, a - k0:b - k0] = leaf.reshape(-1)[a - off:b - off]\
                    .to(pdt)
        del p0
        gen = torch.Generator(device="cpu" if meta else dev)
        return ByzState(params=params, t=0, gen=gen.manual_seed(seed + 1),
                        opt=opt.init(params), tree=tree, mesh=mesh,
                        split=split)

    return init


def _buffer(bufs: dict, name: str, shape, dtype, device) -> torch.Tensor:
    """A scratch stack kept across steps (allocated once)."""
    b = bufs.get(name)
    if b is None or b.shape != tuple(shape) or b.dtype != dtype \
            or b.device != device:
        bufs.pop(name, None)
        b = bufs[name] = torch.empty(shape, dtype=dtype, device=device)
    return b


def _masks(idx: torch.Tensor, G: int) -> torch.Tensor:
    """``[G_recv, q]`` delivered indices -> ``[G_recv, G]`` bool masks."""
    masks = torch.zeros((idx.shape[0], G), dtype=torch.bool,
                        device=idx.device)
    return masks.scatter_(1, idx.long(), True)


def _pull_rows(ranks: _Ranks, rows, masks, cfg, rule, out) -> None:
    """The masked ``rule`` for the rank's receivers over ``rows``' chunks
    into ``out`` (``[G/rep, P_k]``)."""
    chunks, rows_of = rows
    mine = masks[ranks.r0:ranks.r1]
    for c0, c1 in chunks:
        masked_pull(rows_of(c0, c1), mine, cfg, rule=rule,
                    out=out[:, c0:c1])


def _group_grads(bundle, tree, pulled, batch, cfg, ranks, bufs, out,
                 local_batch: bool = False):
    """Per-group gradients of the rank's groups into ``out`` (``[G/rep,
    P_k]``). With 'fsdp' ranks the pulled rows are gathered whole, each rank
    differentiates its part of the batch rows weighted by its share, and
    the parts are summed to column shards in rank order. With 'model'
    ranks ``tree`` is the rank's blocks' and the loss runs under the train
    mesh's rule table, or a problem's under the MLP's (tensor parallelism
    over the 'model' line)."""
    n_micro = cfg.grad_microbatches
    part, share = ranks.batch_part(batch, n_micro, local_batch)
    rules = None
    if ranks.split is not None and isinstance(bundle.cfg, _ProblemCfg):
        from ..configs.paper_models import mlp_rules
        rules = mlp_rules(ranks.split, ranks.mesh)
    elif ranks.split is not None:
        from ..launch.steps import train_rules
        rules = train_rules(ranks.mesh, bundle.cfg)
    with _sharding.sharding_rules(rules):
        if ranks.K == 1:
            return group_grads(bundle, tree, pulled, part, n_micro, out)
        whole = _buffer(bufs, "grads_whole", (out.shape[0], tree.size),
                        out.dtype, out.device)
        if share > 0:
            group_grads(bundle, tree, ranks.cols_gather(pulled, "fsdp"),
                        part, n_micro, whole).mul_(share)
        else:
            whole.zero_()
    out.copy_(ranks.cols_sum(whole, "fsdp"))
    return out


def _attack_grads(grads, attack, tree, ranks) -> None:
    """The gradient attack on the stack, in place on the rank's rows."""
    if ranks.trivial:
        inject_gradients(grads, attack.spec, attack.gen, tree=tree,
                         inplace=True)
        return
    chunks, rows_of = ranks.rows(grads, "attack", attack, tree)
    for c0, c1 in chunks:
        grads[:, c0:c1] = rows_of(c0, c1)[ranks.r0:ranks.r1]


def _aggregate(grads, weights, cfg, ranks) -> torch.Tensor:
    """``G_hat`` for the rank's receivers, in place on ``grads``:
    ``naive`` gathers each chunk over 'rep' and forms its receivers' sums;
    ``sharded`` forms its senders' partial sums for every receiver and
    reduces them over 'rep' in rank order. In ``cfg.exchange_dtype``."""
    if ranks.rep == 1:
        return aggregate_gradients(grads, weights, cfg, out=grads)
    dt = _dtype(cfg.exchange_dtype)
    w = weights.to(dt)
    for c0, c1 in _chunks(grads.shape[1], cfg.n_groups, grads.element_size(),
                          cfg.chunk_bytes):
        if cfg.engine == "naive":
            full = ranks.mesh.all_gather(grads[:, c0:c1], "rep", "aggregate")
            grads[:, c0:c1] = torch.matmul(w[ranks.r0:ranks.r1], full.to(dt))
        else:
            part = torch.matmul(w[:, ranks.r0:ranks.r1],
                                grads[:, c0:c1].to(dt))
            grads[:, c0:c1] = ranks.rows_sum(part, "aggregate")
    return grads


def make_scatter_step(bundle, pcfg: ProtocolConfig, lr_schedule,
                      with_attack: bool = False, delivery=None, mesh=None,
                      local_batch: bool = False):
    """One ByzSGD scatter step ``(state, batch) -> state``; batch leaves
    ``[G, per_group, ...]`` (``[n_micro, G, ...]`` with micro-batches):
    every rank of a ``mesh`` passes the whole batch and keeps its part
    (with ``local_batch``, only its part: ``[(n_micro,) G/rep,
    per_group/K, ...]``).

    ``delivery`` is a :class:`~repro_torch.core.quorum.UniformDelivery`
    (the default) or a :class:`~repro_torch.core.quorum.TraceDelivery`
    replaying quorum tables; every rank draws the full tables. The pulled
    view (in the model's ``act_dtype``, as the JAX step casts it) and the
    gradient stack are scratch buffers kept across steps."""
    G = pcfg.n_groups
    delivery = delivery or UniformDelivery(G, G, pcfg.q_workers,
                                           pcfg.q_servers)
    optimizer = _optim.get(pcfg.optimizer)
    byz = pcfg.byz
    act = _dtype(bundle.cfg.act_dtype)
    xdt = _dtype(pcfg.exchange_dtype)
    bufs: dict = {}

    def scatter_step(state: ByzState, batch) -> ByzState:
        params, gen, dev = state.params, state.gen, state.params.device
        ranks = _Ranks(mesh, G, state.tree.size, pcfg.chunk_bytes,
                       state.split)
        eta = lr_schedule(state.t)

        # 1. worker pull -----------------------------------------------------
        with span("byzsgd.pull"):
            inject = (_Attack("models", byz, gen)
                      if with_attack and byz.server_attack else None)
            rows = ranks.rows(params, "pull", inject, state.tree)
            pdt = act if params.dtype == torch.float32 else params.dtype
            pulled = _buffer(bufs, "pulled", params.shape, pdt, dev)
            if pcfg.pull == "roundrobin":
                _roundrobin_pull(rows, params, state.t, eta, pcfg, pulled,
                                 ranks)
            else:
                masks = _masks(delivery.pull_indices(gen, state.t,
                                                     gen.device), G)
                _pull_rows(ranks, rows, masks, pcfg, None, pulled)
            del rows

        # 2. per-group worker gradients --------------------------------------
        with span("byzsgd.grads"):
            grads = _buffer(bufs, "grads", params.shape, xdt, dev)
            _group_grads(bundle, ranks.local_tree or state.tree, pulled,
                         batch, pcfg, ranks, bufs, grads, local_batch)
        if with_attack and byz.worker_attack:
            with span("byzsgd.attack"):
                _attack_grads(grads, _Attack("grads", byz, gen), state.tree,
                              ranks)

        # 3. gradient rule (MDA by default) per server over its quorum -------
        with span("byzsgd.select"):
            push_idx = delivery.push_indices(gen, state.t, gen.device)
            d2 = agg.rules.sqdists_from_gram(ranks.gram(grads))
            weights = quorum_weights(d2, push_idx, pcfg.f_workers, pcfg)
        with span("byzsgd.aggregate"):
            g_hat = _aggregate(grads, weights, pcfg, ranks)

        # 4. local update ----------------------------------------------------
        with span("byzsgd.update"):
            new_params, new_opt = optimizer.update(g_hat, state.opt, params,
                                                   eta)
        return state._replace(params=new_params, t=state.t + 1, opt=new_opt)

    return scatter_step


def make_gather_step(pcfg: ProtocolConfig, with_attack: bool = False,
                     delivery=None, mesh=None):
    """DMC: servers exchange replicas and apply the masked ``gather_gar``
    (Median by default) every T steps, in place on the replica stack."""
    G = pcfg.n_groups
    delivery = delivery or UniformDelivery(G, G, pcfg.q_workers,
                                           pcfg.q_servers)

    def gather_step(state: ByzState) -> ByzState:
        params, dev = state.params, state.params.device
        ranks = _Ranks(mesh, G, state.tree.size, pcfg.chunk_bytes,
                       state.split)
        with span("byzsgd.gather"):
            masks = _masks(delivery.gather_indices(state.gen, state.t,
                                                   state.gen.device), G)
            inject = (_Attack("models", pcfg.byz, state.gen)
                      if with_attack and pcfg.byz.server_attack else None)
            rows = ranks.rows(params, "gather", inject, state.tree)
            _pull_rows(ranks, rows, masks, pcfg, pcfg.gather_gar, params)
        return state

    return gather_step


def make_train_step(bundle, pcfg: ProtocolConfig, lr_schedule,
                    with_attack: bool = False, delivery=None, mesh=None,
                    local_batch: bool = False):
    """Scatter, then the DMC gather iff the advanced counter hits a
    multiple of T. For the step the objects alive at its start are frozen
    out of the garbage collector's passes (``gc.freeze``) and given back
    at its end (``gc.unfreeze``), unless something else froze objects
    first."""
    delivery = delivery or UniformDelivery(
        pcfg.n_groups, pcfg.n_groups, pcfg.q_workers, pcfg.q_servers)
    scatter = make_scatter_step(bundle, pcfg, lr_schedule, with_attack,
                                delivery, mesh, local_batch)
    gather = make_gather_step(pcfg, with_attack, delivery, mesh)

    def train_step(state: ByzState, batch) -> ByzState:
        # the step's many short-lived objects (autograd's, the remat's)
        # bring on the collector's full passes; over the whole heap each
        # took 0.18-0.26 s, every few steps of a host-paced model on the
        # card, while the launch queue ran dry. Frozen, the heap is not
        # traversed, and the passes see only what the step made
        scoped = gc.get_freeze_count() == 0
        if scoped:
            gc.freeze()
        try:
            with span("byzsgd.step"):
                state = scatter(state, batch)
                return gather(state) if state.t % pcfg.T == 0 else state
        finally:
            if scoped:
                gc.unfreeze()

    return train_step


# ---------------------------------------------------------------------------
# serving-side consolidation
# ---------------------------------------------------------------------------


def consolidate(params: torch.Tensor, pcfg: ProtocolConfig | None = None,
                chunk_bytes: int | None = None, *, mesh: Mesh | None = None,
                n_params: int | None = None,
                split: ModelSplit | None = None,
                blocks: bool = False) -> torch.Tensor:
    """Median of the replicas -> one ``[P]`` serving model (DMC applied
    once, full delivery), streamed by column chunks (``pcfg``'s, or the
    default's without one). On a ``mesh`` (``params`` a rank's block of a
    stack of ``pcfg.n_groups`` rows and ``n_params`` columns; ``split`` its
    'model' blocks) each chunk of the rank's columns is gathered over 'rep'
    and the medians over 'fsdp' and 'model': every rank gets the whole
    model — or, with ``blocks``, its 'model' blocks of it (``[P_m]``, as
    a tensor-parallel server holds them)."""
    cb = chunk_bytes or (pcfg or ProtocolConfig).chunk_bytes
    G = pcfg.n_groups if mesh is not None else params.shape[0]
    ranks = _Ranks(mesh, G, n_params or params.shape[1], cb, split)
    chunks, rows_of = ranks.rows(params, "consolidate")
    if ranks.trivial:
        chunks = _chunks(params.shape[1], G, 4, cb)
    out = torch.empty(params.shape[1], dtype=params.dtype,
                      device=params.device)
    for c0, c1 in chunks:
        out[c0:c1] = agg.dispatch.cwise_median(rows_of(c0, c1).float())
    out = ranks.cols_gather(out[None], "consolidate")
    return (out if blocks else ranks.model_join(out, "consolidate"))[0]


# ---------------------------------------------------------------------------
# ByzState <-> checkpoint leaves
# ---------------------------------------------------------------------------


def replica(state: ByzState, g: int, *, everywhere: bool = True,
            blocks: bool = False):
    """Replica ``g``'s whole flat row ``[P]`` on every rank (a collective
    on a mesh: every rank calls it; a view of the stack off one). With
    ``everywhere=False`` only the ranks that hold the row's columns get it
    (gathered over their 'fsdp' line, no broadcast over 'rep'); the others
    get ``None``; with ``blocks`` as well, those ranks get their 'model'
    blocks' row ``[P_m]`` (``state.split.local`` names it), not joined
    over 'model'."""
    mesh = state.mesh
    G = state.params.shape[0] * (mesh.size("rep") if mesh else 1)
    ranks = _Ranks(mesh, G, state.tree.size, ProtocolConfig.chunk_bytes,
                   state.split)
    if everywhere:
        return ranks.row(state.params, g, "metrics")
    if not ranks.r0 <= g < ranks.r1:
        return None
    row = ranks.cols_gather(state.params[g - ranks.r0][None], "metrics")
    return (row if blocks else ranks.model_join(row, "metrics"))[0]


def _on_ranks(mesh: Mesh | None) -> bool:
    return mesh is not None and mesh.n_ranks > 1


def _run_state(state: ByzState) -> torch.Tensor:
    """The generator's state, then the step counter and AdamW's count as
    int64, in one uint8 tensor on the host."""
    count = state.opt.count if state.opt else 0
    return torch.cat([state.gen.get_state(), torch.tensor(
        [state.t, count], dtype=torch.int64).view(torch.uint8)])


def share_run_state(state: ByzState, upto: int, tag: str) -> ByzState:
    """Rank 0's step counter, AdamW's count and generator state on the
    world's ranks past the end of the state's mesh and below ``upto`` (a
    collective of every rank of the world: :meth:`Mesh.share`). Those
    ranks get the state back with them, on a new generator; every other
    rank gets it as it is. A rank that sits a segment out runs no step, so
    its counters and generator fall behind the mesh's, which draw the same
    stream on every rank; this brings them level."""
    mesh = state.mesh
    if not _on_ranks(mesh) or upto <= mesh.n_ranks:
        return state
    buf = mesh.share(_run_state(state), upto, tag)
    if mesh.member or mesh.rank >= upto:
        return state
    gen = torch.Generator(device=state.gen.device)
    gen.set_state(buf[:-16].clone())
    t, count = (int(v) for v in buf[-16:].clone().view(torch.int64))
    opt = state.opt._replace(count=count) if state.opt else state.opt
    return state._replace(t=t, gen=gen, opt=opt)


def whole_state(state: ByzState, *, tag: str = "checkpoint",
                upto: int | None = None) -> ByzState:
    """The state with its stacks (params and AdamW's moments) gathered
    whole, ``[G, P]``, on every rank of its mesh (a collective: every rank
    calls it), counted under ``tag``; the state itself off a mesh.

    On a mesh that leaves ranks idle the mesh's ranks gather the stacks,
    and rank 0 hands them, with the run's counters and generator
    (:func:`share_run_state`), to the idle ranks below ``upto`` (default:
    every rank of the world, each of which calls it then; ``upto=0``: the
    mesh's ranks only, the idle ones not calling). An idle rank at or past
    ``upto`` gets its state back as it is."""
    if not _on_ranks(state.mesh):
        return state
    mesh = state.mesh
    upto = mesh.world if upto is None else upto
    stacks = [state.params] + ([state.opt.m, state.opt.v] if state.opt
                               else [])
    if mesh.member:
        ranks = _Ranks(mesh, state.params.shape[0] * mesh.size("rep"),
                       state.tree.size, ProtocolConfig.chunk_bytes,
                       state.split)
        whole = [ranks.gather_all(x, tag) for x in stacks]
    elif mesh.rank < upto:
        whole = [x.new_empty((x.shape[0], state.tree.size)) for x in stacks]
    else:
        whole = [None] * len(stacks)
    state = share_run_state(state, upto, tag)
    for x in whole:
        mesh.share(x, upto, tag)
    if whole[0] is None:
        return state
    opt = state.opt
    if opt:
        opt = type(opt)(whole[1], whole[2], opt.count)
    return state._replace(params=whole[0], opt=opt, mesh=None, split=None)


def shard_state(state: ByzState, mesh: Mesh | None,
                split: ModelSplit | None = None) -> ByzState:
    """A whole state's block for this rank of ``mesh`` (copies of its rows,
    its 'model' blocks under ``split`` and its 'fsdp' columns of each
    stack); on a rank that sits the mesh out, the empty ``[G, 0]``
    stacks."""
    if not _on_ranks(mesh):
        return state._replace(mesh=mesh)
    ranks = _Ranks(mesh, state.params.shape[0], state.tree.size,
                   ProtocolConfig.chunk_bytes, split)

    def cut(x):
        if not mesh.member:
            return x.new_empty((x.shape[0], 0))
        return ranks.to_local(x[ranks.r0:ranks.r1]).clone()

    opt = state.opt
    if opt:
        opt = type(opt)(cut(opt.m), cut(opt.v), opt.count)
    return state._replace(params=cut(state.params), opt=opt, mesh=mesh,
                          split=ranks.split)


def checkpoint_leaves(state: ByzState) -> list[tuple[str, Any]]:
    """``(name, value)`` of every leaf a checkpoint of ``state`` holds, in
    the names and order of a JAX ``ByzState`` checkpoint: ``.params/<path>``
    as ``[G, *shape]`` views of the stack, ``.t`` (int32), ``.key`` (uint32
    ``[2]``, the generator's seed: a JAX restore of a port checkpoint reads
    it and starts a new stream), AdamW's ``.opt/.m/<path>``,
    ``.opt/.v/<path>`` and ``.opt/.count``; then the port's own ``.gen``,
    the generator's state (uint8), which a JAX restore ignores. On a mesh
    the stacks are gathered whole first (every rank of the mesh calls
    this; a rank that sits it out does not)."""
    state = whole_state(state, upto=0)
    tree = state.tree
    G = state.params.shape[0]

    def stacked(prefix, flat):
        return [(f"{prefix}/" + "/".join(path),
                 flat[:, off:off + size].reshape((G,) + shape))
                for path, shape, (off, size) in zip(tree.paths, tree.shapes,
                                                    tree.spans())]

    seed = state.gen.initial_seed()
    out = stacked(".params", state.params)
    out += [(".t", np.asarray(state.t, np.int32)),
            (".key", np.asarray([(seed >> 32) & 0xFFFFFFFF,
                                 seed & 0xFFFFFFFF], np.uint32))]
    if state.opt:
        out += stacked(".opt/.m", state.opt.m) + stacked(".opt/.v",
                                                         state.opt.v)
        out.append((".opt/.count", np.asarray(state.opt.count, np.int32)))
    out.append((".gen", state.gen.get_state()))
    return out


def tree_from_manifest(leaves: dict) -> FlatTree:
    """The :class:`FlatTree` of the ``.params/<path>`` leaves a checkpoint
    manifest lists (their shapes without the replica axis), in the JAX leaf
    order the names were written in."""
    paths, shapes = [], []
    for name, info in leaves.items():
        if name.startswith(".params/"):
            paths.append(tuple(name.split("/")[1:]))
            shapes.append(tuple(info["shape"][1:]))
    if not paths:
        raise ValueError("the checkpoint holds no replica-stacked "
                         ".params/<path> leaves")
    return FlatTree(paths, shapes)


def state_from_leaves(read: Callable[[str], torch.Tensor], leaves: dict,
                      device, *, tree: FlatTree | None = None,
                      params_only: bool = False) -> ByzState:
    """A ``ByzState`` on ``device`` from checkpoint leaves: ``leaves`` is the
    manifest's name -> info map, ``read(name)`` a leaf's tensor on the
    host. The ``.params/<path>`` leaves fill one ``[G, P]`` stack in
    ``tree``'s order (default: the manifest's), leaf by leaf; AdamW's
    moments likewise. The generator takes the checkpoint's ``.gen`` state;
    a checkpoint without one (a JAX checkpoint) starts a new stream seeded
    from ``.key``. ``params_only`` (serving, consolidation) reads neither
    the moments nor ``.gen``, so it takes a checkpoint saved on any device
    type; a full restore needs a generator of the device type that saved
    it (a CUDA generator's state is 16 bytes, a CPU one's about 5 KB)."""
    tree = tree or tree_from_manifest(leaves)
    G = leaves[".params/" + "/".join(tree.paths[0])]["shape"][0]

    def stack(prefix):
        out = None
        for path, shape, (off, size) in zip(tree.paths, tree.shapes,
                                            tree.spans()):
            name = f"{prefix}/" + "/".join(path)
            if name not in leaves:
                raise KeyError(f"checkpoint has no leaf {name!r}")
            if tuple(leaves[name]["shape"]) != (G,) + shape:
                raise ValueError(f"leaf {name!r} is {leaves[name]['shape']}"
                                 f"; expected {[G, *shape]}")
            leaf = read(name)
            if out is None:
                out = torch.empty((G, tree.size), dtype=leaf.dtype,
                                  device=device)
            elif leaf.dtype != out.dtype:
                raise ValueError(f"leaf {name!r} is {leaf.dtype}; the "
                                 f"stack is {out.dtype}")
            out[:, off:off + size] = leaf.reshape(G, size).to(device)
            del leaf
        return out

    params = stack(".params")
    t = int(read(".t")) if ".t" in leaves else 0
    gen = torch.Generator(device=device)
    key = read(".key").numpy().astype(np.uint64) if ".key" in leaves \
        else np.zeros(2, np.uint64)
    seed = int(key[0]) << 32 | int(key[1])
    opt: Any = ()
    if params_only:
        gen.manual_seed(seed)
        return ByzState(params=params, t=t, gen=gen, tree=tree)
    if ".gen" in leaves:
        try:
            gen.set_state(read(".gen"))
        except RuntimeError as err:
            raise ValueError(
                f"the checkpoint's generator state ({leaves['.gen']['shape']}"
                f" bytes) was saved on another device type than "
                f"{torch.device(device).type}: resume on that device type, "
                "or restore the params only") from err
    else:
        gen.manual_seed(seed)
    if ".opt/.count" in leaves:
        from ..optim.adamw import AdamWState
        opt = AdamWState(stack(".opt/.m"), stack(".opt/.v"),
                         int(read(".opt/.count")))
    return ByzState(params=params, t=t, gen=gen, opt=opt, tree=tree)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _ProblemCfg:
    """Dtype carrier for paper-scale problems driven through the protocol
    (the LM path passes full model-bundle configs instead)."""
    param_dtype: str = "float32"
    act_dtype: str = "float32"


@dataclass(frozen=True)
class ProblemBundle:
    """Wraps an ``(init_fn(gen, device), loss_fn)`` problem (the
    ``configs.paper_models`` factories) into the bundle interface the step
    functions expect (``init``/``loss``/``cfg`` dtypes)."""
    init: Callable
    loss: Callable
    cfg: _ProblemCfg = field(default_factory=_ProblemCfg)

    def meta_params(self) -> dict:
        """The problem's params as ``meta`` tensors (``make_init_fn`` on
        ``device="meta"``): its init run under a fake-tensor mode, so
        nothing is drawn or allocated."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            fake = self.init(torch.Generator())
        return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in fake.items()}


class ProtocolEngine:
    """Epochs over the protocol: the scatter step, and the DMC gather after
    the step whose advanced counter is a multiple of T (any epoch length is
    correct), with per-step metrics — accuracy of group 0's replica on the
    ``metrics_every`` stride, the Lemma 4.2/4.3 diameters with
    ``track_delta`` — written to device buffers, and ONE host transfer per
    :meth:`run`. The eager counterpart of the JAX engine's donated
    ``lax.scan`` epochs (its compile cache has nothing to cache here).

    With ``pull="median"`` (the asynchronous schedule) and the same quorums
    the engine is the single-host ``EpochEngine``'s protocol: the two agree
    step for step on a G = n_workers = n_servers cluster.
    ``pull="roundrobin"`` is the protocol's own §5 formulation.

    On a ``mesh`` every rank runs the engine on its block; the metrics read
    group 0's whole replica (broadcast from its 'rep' rank) and, with
    ``track_delta``, the whole stack (gathered: test scale), so every rank
    returns the same buffers.
    """

    def __init__(self, bundle, pcfg: ProtocolConfig, lr_schedule, *,
                 delivery=None, with_attack: bool = False,
                 acc_fn: Callable | None = None,
                 eval_set: tuple | None = None, track_delta: bool = False,
                 metrics_every: int = 1, device=None,
                 mesh: Mesh | None = None):
        if (acc_fn is None) != (eval_set is None):
            raise ValueError("acc_fn and eval_set must be given together")
        if metrics_every < 1:
            raise ValueError("metrics_every must be >= 1")
        self.bundle = bundle
        self.cfg = pcfg
        self.lr = lr_schedule
        self.device = resolve(device)
        self.with_attack = with_attack
        self.delivery = delivery or UniformDelivery(
            pcfg.n_groups, pcfg.n_groups, pcfg.q_workers, pcfg.q_servers)
        self.acc_fn = acc_fn
        self.eval_set = eval_set
        self.track_delta = track_delta
        self.metrics_every = metrics_every
        self.mesh = mesh
        self.scatter = make_scatter_step(bundle, pcfg, lr_schedule,
                                         with_attack, self.delivery, mesh)
        self.gather = make_gather_step(pcfg, with_attack, self.delivery,
                                       mesh)

    def init_state(self, seed: int) -> ByzState:
        return make_init_fn(self.bundle, self.cfg, self.device,
                            self.mesh)(seed)

    def _ranks(self, state: ByzState) -> _Ranks:
        return _Ranks(self.mesh, self.cfg.n_groups, state.tree.size,
                      self.cfg.chunk_bytes, state.split)

    def _acc(self, state: ByzState):
        row = replica(state, 0)
        with torch.no_grad():
            return self.acc_fn(state.tree.unflatten(row), *self.eval_set)

    def diameters(self, state: ByzState) -> tuple:
        """(Delta_t, the L2 diameter) of the honest replicas."""
        h = self.cfg.n_groups - self.cfg.byz.n_byz_servers
        ranks = self._ranks(state)
        full = (state.params if ranks.trivial
                else ranks.gather_all(state.params, "metrics"))
        return coordinatewise_diameter_sum(full, h), l2_diameter(full, h)

    def run_epoch(self, state: ByzState, batches, bufs: dict, at: int):
        """``L`` steps over ``batches`` (leaves ``[L, G, ...]``), writing
        step ``at + i``'s metrics into ``bufs`` on the device."""
        leaves = batches.values() if isinstance(batches, dict) else batches
        L = next(iter(leaves)).shape[0]
        for i in range(L):
            state = self.scatter(state, _index(batches, i))
            delta_pre = (self.diameters(state)[0]
                         if self.track_delta else None)
            if state.t % self.cfg.T == 0:
                state = self.gather(state)
            k = at + i
            if self.acc_fn is not None and \
                    (state.t - 1) % self.metrics_every == 0:
                bufs["acc"][k] = self._acc(state)
            if self.track_delta:
                bufs["delta_pre"][k] = delta_pre
                bufs["delta"][k], bufs["l2_diam"][k] = self.diameters(state)
        return state

    def run(self, state: ByzState, batches=None, *, stream=None,
            steps: int | None = None, epoch_steps: int | None = None):
        """Run ``steps`` protocol steps in epochs of ``epoch_steps``
        (default T) from ``batches`` (leaves ``[steps, G, ...]``) or a
        ``stream`` with ``next(L)``. Returns the final state and the host
        metric buffers ``[steps]`` (one transfer)."""
        if (batches is None) == (stream is None):
            raise ValueError("provide exactly one of batches/stream")
        if steps is None:
            if batches is None:
                raise ValueError("steps is required with stream input")
            leaves = batches.values() if isinstance(batches, dict) \
                else batches
            steps = next(iter(leaves)).shape[0]
        dev = state.params.device
        names = (["acc"] if self.acc_fn is not None else []) + (
            ["delta_pre", "delta", "l2_diam"] if self.track_delta else [])
        bufs = {k: torch.zeros(steps, dtype=torch.float32, device=dev)
                for k in names}
        L = epoch_steps or self.cfg.T
        done = 0
        while done < steps:
            n = min(L, steps - done)
            if batches is not None:
                chunk = ({k: v[done:done + n] for k, v in batches.items()}
                         if isinstance(batches, dict)
                         else tuple(v[done:done + n] for v in batches))
            else:
                chunk = stream.next(n)
            state = self.run_epoch(state, chunk, bufs, done)
            done += n
        if not bufs:
            return state, {}
        keys = list(bufs)
        host = torch.stack([bufs[k] for k in keys]).cpu().numpy()
        return state, {k: np.asarray(host[i]) for i, k in enumerate(keys)}


def collective_volume_bytes(pcfg: ProtocolConfig, n_params: int,
                            *, fsdp: int = 1, rep: int | None = None,
                            model: int = 1) -> int:
    """Modeled per-device cross-'rep' exchange (bytes) of one scatter
    step's payloads on a mesh: the masked Median pull all-gathers the
    ``[G, P]`` stack, ``(G-1)·P·itemsize``, and the ``[G, G] x [G, P]``
    aggregation moves as much again; with an 'fsdp' axis of size K each
    device moves 1/K of it, and with a 'model' axis of size M 1/M (a
    rank's blocks; a leaf whole on every 'model' rank, a norm's scale,
    moves on each, so the payload is ``P_m = ModelSplit.local.size``,
    which ``n_params`` may give with ``model=1``). That is a mesh with
    rep = G (one group a rank, the default); with ``rep`` ranks holding
    G/rep groups each, a rank sends ``(rep-1)·(G/rep)`` rows in each
    exchange, ``2·(rep-1)·(G/rep)·P·itemsize / (K·M)`` a step. On one card
    the groups share the device and nothing crosses a link.

    ``Mesh.sent`` counts what the ranks send; the model covers its tags
    ``pull`` (the replicas move in their own dtype) and ``aggregate``. The
    port's other exchanges, per rank, are outside it:

    * ``gram`` — the all-to-all over 'rep' of the gradient block,
      ``(rep-1)/rep · (G/rep) · P_k · 4`` bytes, and the ``[G, G]`` float32
      partials gathered over 'fsdp', 'rep' and 'model';
    * ``fsdp`` (K > 1) — the pulled rows gathered over 'fsdp', ``(K-1) ·
      (G/rep) · ceil(P/K) · act_itemsize``, and the gradient parts summed
      to column shards, ``(K-1)/K · (G/rep) · K·ceil(P/K) · itemsize``;
    * ``model``, ``model_leaves``, ``model_loss`` (M > 1) — the tensor
      parallelism inside each group's loss and gradient,
      :func:`model_volume_bytes`;
    * ``gather`` — the DMC gather's ``(rep-1) · (G/rep) · P_k · itemsize``
      on the steps that end a round;
    * ``attack``, ``metrics``, ``consolidate``, ``checkpoint`` — the
      adversary's gathers, group 0's replica and the diameters' stack,
      the served model, a save's stacks."""
    itemsize = _dtype(pcfg.exchange_dtype).itemsize
    G = pcfg.n_groups
    rep = G if rep is None else rep
    return 2 * (rep - 1) * (G // rep) * n_params * itemsize // (fsdp * model)


def _attn_values(n: int, D: int, H: int, kvH: int, hd: int, M: int):
    """(forward, backward) values one attention sub-block of n tokens
    moves over 'model' (before remat's second forward): the q / k / v
    layouts of :func:`attn_overrides` and ``wo``'s reduction."""
    q_split, kv_split = H % M == 0, kvH % M == 0
    d_split = D % M == 0
    fwd = bwd = 0
    if not q_split and d_split:
        fwd += n * H * hd
        bwd += n * D // M
    if not kv_split and d_split:
        fwd += 2 * n * kvH * hd
        bwd += 2 * n * D // M
    if q_split:
        bwd += n * D                      # the copy before column-parallel
        if not kv_split:
            bwd += 2 * n * kvH * hd       # k and v shared by every rank
    if (H * hd) % M == 0:
        fwd += n * D
        if not q_split:
            bwd += n * H * hd // M
    return fwd, bwd


def _divides(n: int, M: int) -> bool:
    return n % M == 0 and n >= M


def _mlp_volume_values(tree: FlatTree, M: int, rows: int) -> int:
    """The values one rank's copy of the MLP's split form
    (``configs.paper_models``) sends over 'model' in one loss and gradient
    of ``rows`` rows, before the factor M - 1: per layer, a split input
    gathered before a column-parallel or whole weight (forward), the sum of
    a column-parallel product's input gradient (backward; the first
    layer's input, the data, has none) and its bias block's gradient
    gathered, a whole input's gradient blocks gathered before a
    row-parallel product (backward; none for the data) and the product's
    partials summed (forward); then split logits gathered."""
    shapes = dict(zip((p[0] for p in tree.paths), tree.shapes))
    dims = dict(zip((p[0] for p in tree.paths),
                    model_dims(tree, M, None)))
    values, split, grad = 0, False, False
    for i in range(len(shapes) // 2):
        a, b = shapes[f"w{i}"]
        d = dims[f"w{i}"]
        if d == 1:
            values += (rows * a // M if split else 0) \
                + (rows * a if grad else 0) + b // M
        elif d == 0:
            values += (rows * a // M if grad and not split else 0) + rows * b
        elif split:
            values += rows * a // M
        split, grad = d == 1, True
    return values + (rows * b // M if split else 0)


def model_volume_bytes(cfg, M: int, tokens: int, n_groups: int = 1, *,
                       seq: int | None = None,
                       frames: int | None = None,
                       tree: FlatTree | None = None) -> dict:
    """The bytes one rank sends over 'model' (all-gathers of ``M - 1``
    blocks; every reduction is one) for ``n_groups`` losses and gradients
    of ``tokens`` tokens each (a rank's groups and its 'fsdp' part of
    their rows) of the model ``cfg`` at M ranks, by tag, as the families'
    split forms run them with block remat (each remat'd block's forward
    twice, but for what follows the last tensor its backward needs: the
    recomputation stops there, so a block ending in a reduction — the
    dense and MoE FFN, Mamba2's ``out_proj``, whisper's GELU MLP and its
    ``b_down`` — reduces once) and the loss by sequence chunks (each
    chunk's statistics twice):

    * ``model`` — per attention block, forward (x2): a row-parallel q, k
      or v (heads not split) reduces its ``[N, H hd]`` / ``[N, kvH hd]``,
      wo reduces ``[N, D]``; backward: one ``[N, D]`` sum before
      column-parallel q/k/v (a column-parallel q alone when k/v are not),
      a ``[N, D/M]`` gather for each row-parallel projection's input, the
      shared k/v's ``[N, kvH hd]`` each when q alone splits, wo's input
      gather when the heads are whole. The FFNs: SwiGLU and GELU one
      ``[N, D]`` reduction forward and one sum backward; the MoE the same
      on the combined ``[T, D]`` plus the routing weights' ``[E, C]``
      float32 sum backward (per routing chunk); Mamba2 (remat'd; the
      shared block is not) ``in_proj``'s ``[N, 2 d_inner + 2N + H]``
      reduction (x2) and ``out_proj``'s ``[N, D]``, backward their inputs'
      ``[N, D/M]`` and ``[N, d_inner/M]`` gathers; RWKV6 (every
      reduction x2) r/k/v/g's joined ``[N, 4D]``, the LoRA's ``[N, 64]``
      and ``[N, D]`` in float32, ``Wo``'s ``[N, D]`` and the channel
      mix's joined ``[N, 2D]``, backward each row-parallel input's
      ``[N, in/M]`` gather and the ``[N, D]`` sum before ``cWk``; whisper's
      cross-attention the sum of the ``frames`` x D encoder output before
      its k/v (one per decoder block). Then the embedding's ``[N, D]``
      reduction (token inputs; the vlm family takes embeddings) and the
      hidden's ``[N, D]`` sum before the vocab-parallel logits, and
      whisper's ``pos_dec`` rows, ``[seq, D]``, once;
    * ``model_leaves`` — each block's leaves split over 'model' that are
      gathered whole at use (the norms, the MoE router, the Mamba2 conv,
      decay and norm leaves, RWKV6's token-shift, decay and norm leaves,
      whisper's ``b_down`` once), twice;
    * ``model_loss`` — per token three float32 statistics, twice.

    Every activation and leaf moves in ``cfg.act_dtype``; the MoE's
    routing weights and RWKV6's LoRA in float32. ``seq`` (whisper: the
    decoder's sequence length) defaults to ``tokens``, ``frames`` (its
    encoder frames) to ``tokens``.

    The paper's MLP problem (``cfg`` a :class:`ProblemBundle`'s, ``tree``
    its leaves, ``tokens`` the rows a rank differentiates for a group):
    ``model`` counts its split form's activations and bias gradients
    (:func:`_mlp_volume_values`), ``model_loss`` the L2 term's one float32
    sum over the split leaves; no leaf is gathered whole."""
    if M == 1:
        return {}
    a = _dtype(cfg.act_dtype).itemsize
    if isinstance(cfg, _ProblemCfg):
        if tree is None:
            raise ValueError("model_volume_bytes of a problem needs its "
                             "tree (the MLP's leaves)")
        out = {"model": _mlp_volume_values(tree, M, tokens) * a}
        if any(d is not None for d in model_dims(tree, M, None)):
            out["model_loss"] = 4
        return {k: v * (M - 1) * n_groups for k, v in out.items() if v}
    N, D, hd = tokens, cfg.d_model, cfg.hd
    H, kvH, F = attn_counts(cfg)
    fam = cfg.family
    d_split = D % M == 0
    ffn_split = _divides(F, M)
    model = leaves = 0          # bytes
    n_norm = 2 if cfg.norm == "layernorm" else 1
    if fam in ("dense", "vlm", "moe"):
        fwd, bwd = _attn_values(N, D, H, kvH, hd, M)
        if fam == "moe":
            per_block = (2 * fwd + bwd) * a
            if ffn_split:        # the expert F over 'model'
                per_block += 2 * N * D * a
                from ..models.moe import MOE_CHUNK_TOKENS
                T, nc = N, 1
                if T > MOE_CHUNK_TOKENS:
                    nc = -(-T // MOE_CHUNK_TOKENS)
                    while T % nc:
                        nc += 1
                E = cfg.n_experts
                cap = min(max(int(T // nc * cfg.top_k / E
                                  * cfg.capacity_factor), 1), T // nc)
                per_block += nc * E * cap * 4
            if _divides(D, M) or _divides(cfg.n_experts, M):
                leaves += cfg.n_layers * 2 * D * cfg.n_experts // M * a
        else:
            if ffn_split:
                fwd += N * D
                bwd += N * D
            per_block = (2 * fwd + bwd - (N * D if ffn_split else 0)) * a
        model += cfg.n_layers * per_block
        if d_split:
            leaves += cfg.n_layers * 2 * 2 * n_norm * D // M * a
    elif fam == "ssm":
        Hr = D // cfg.ssm_head_dim
        lora = 64
        fwd = bwd = 0
        if d_split:
            fwd += 4 * N * D * a + N * lora * 4 + N * D * a + N * D * a
            bwd += (4 * N * D // M + N * D // M + N * D // M) * a \
                + N * D // M * 4
        if _divides(lora, M):
            fwd += N * D * 4
            bwd += N * lora // M * 4
        if ffn_split:
            fwd += N * D * a
            bwd += N * D * a
        model += cfg.n_layers * (2 * fwd + bwd)
        if d_split:
            leaves += cfg.n_layers * 2 * 14 * D // M * a
        if _divides(Hr, M) or _divides(cfg.ssm_head_dim, M):
            leaves += cfg.n_layers * 2 * Hr * cfg.ssm_head_dim // M * a
    elif fam == "hybrid":
        di = cfg.ssm_expand * D
        Hm = di // cfg.ssm_head_dim
        Ns = cfg.ssm_state
        W = 2 * di + 2 * Ns + Hm
        conv_ch = di + 2 * Ns
        per = 0
        if d_split:
            per += 2 * N * W + N * D // M
        if _divides(di, M):
            per += N * D + N * di // M
        model += cfg.n_layers * per * a
        leaf = (D if d_split else 0) + (di if _divides(di, M) else 0) \
            + ((cfg.ssm_conv + 1) * conv_ch if _divides(conv_ch, M) else 0) \
            + (3 * Hm if _divides(Hm, M) else 0)
        leaves += cfg.n_layers * 2 * leaf // M * a
        fwd, bwd = _attn_values(N, D, H, kvH, D // H, M)
        if ffn_split:
            fwd += N * D
            bwd += N * D
        model += (cfg.n_layers // cfg.shared_attn_every) * (fwd + bwd) * a
    elif fam == "audio":
        Ne = N if frames is None else frames
        fe, be = _attn_values(Ne, D, H, kvH, hd, M)
        fs, bs = _attn_values(N, D, H, kvH, hd, M)
        fc, bc = _attn_values(N, D, H, kvH, hd, M)
        # the cross k/v read the encoder's Ne frames, not the N tokens
        if kvH % M == 0:         # one copy of the encoder output
            bc += Ne * D
        elif d_split:
            fc += 2 * (Ne - N) * kvH * hd
            bc += 2 * (Ne - N) * D // M
        if H % M == 0 and kvH % M:
            bc += 2 * (Ne - N) * kvH * hd
        mlp_e = mlp_d = 0
        if ffn_split:
            mlp_e, mlp_d = 2 * Ne * D, 2 * N * D
        model += cfg.encoder_layers * ((2 * fe + be) + mlp_e) * a
        model += cfg.n_layers * ((2 * fs + bs) + (2 * fc + bc) + mlp_d) * a
        from ..models.encdec import MAX_DEC_POSITIONS
        if _divides(MAX_DEC_POSITIONS, M):
            model += (N if seq is None else seq) * D * a
        if d_split:
            leaves += (cfg.encoder_layers * (2 * 2 * 2 + 1)
                       + cfg.n_layers * (3 * 2 * 2 + 1)) * D // M * a
    else:
        raise ValueError(f"model_volume_bytes: family {fam!r}")
    vocab = cfg.vocab % M == 0
    if vocab:
        model += N * D * (1 if fam == "vlm" else 2) * a
    loss = 2 * 3 * N * 4 if vocab else 0
    return {k: v * (M - 1) * n_groups for k, v in
            (("model", model), ("model_leaves", leaves),
             ("model_loss", loss)) if v}


"""Distributed ByzSGD on one card — the port of ``repro.core.protocol``.

The JAX package maps the paper's server/worker protocol onto a
('rep', 'fsdp', 'model') mesh: 'rep' indexes G = n_groups co-located
worker+server groups (the failure domains), each holding a server replica
and computing a worker gradient on its share of the batch. This port runs
the same protocol with the G groups co-located on ONE device, with no mesh:

  * scatter step = pull (per-worker masked Median over the delivered server
    replicas, or the §5 round-robin pull with its distance filter)
    -> per-group gradients (a loop over the G groups)
    -> the gradient rule (MDA) per server over its delivered quorum, as
       selection weights from one Gram of the gradient stack
    -> local update (the optimizer registry);
  * gather step = DMC: the masked Median across server replicas every T
    steps.

Layout: the replica stack, the pulled view and the gradient stack are each
ONE flat ``[G, P]`` tensor in the JAX package's leaf order
(:class:`~repro_torch.core.simulator.FlatTree`, carried in the state), so
the Gram is one launch over ``[G, P]`` and a group's model is a dict of
views into its row. The masked pull, the DMC gather and the gradient
aggregation stream by column chunks of at most ``chunk_bytes``: a
per-receiver gather of the whole ``[G_recv, q, P]`` stack would not fit a
card at full width. The steps update the state's tensors in place (the JAX
steps are pure; on one card the replica stack is the largest tensor there
is, and a second copy would not fit at full width).

Engines: the JAX package's 'naive' and 'sharded' engines differ in how the
aggregation's collectives are laid out across the mesh; on one device there
are no collectives, so both run the same code here. The mesh,
``state_shardings`` and ``torch.distributed`` wait for the multi-GPU port.

:class:`ProtocolEngine` is the eager counterpart of the JAX fused epochs:
the DMC gather at the T boundary driven by the carried step counter,
per-step metrics written to device buffers, one host transfer per ``run``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .. import agg
from .. import optim as _optim
from ..device import resolve
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
    t: int                        # host step counter
    gen: torch.Generator          # quorums and stochastic attacks
    opt: Any = ()                 # per-replica optimizer state
    tree: FlatTree | None = None  # the model's leaves in the flat layout


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
            loss = bundle.loss(params, _index(mb, g))
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
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


def _roundrobin_pull(models: torch.Tensor, own: torch.Tensor, t: int,
                     eta: float, cfg: ProtocolConfig, out: torch.Tensor):
    """The §5 synchronous pull: worker g takes replica ``(g + t + 1) % G``
    and keeps it iff its squared distance to its own replica is within the
    Outliers bound anchored locally, else its own replica."""
    G, P = own.shape
    idx = (torch.arange(G, device=own.device) + t + 1) % G
    chunks = _chunks(P, 2 * G, 4, cfg.chunk_bytes)
    d2g = torch.zeros(G, dtype=torch.float32, device=own.device)
    n2g = torch.zeros(G, dtype=torch.float32, device=own.device)
    for c0, c1 in chunks:
        ow = own[:, c0:c1].float()
        d2g += torch.sum((models[idx, c0:c1].float() - ow) ** 2, dim=1)
        n2g += torch.sum(ow ** 2, dim=1)
    growth = ((3.0 * cfg.T + 2.0) * (G - cfg.f_workers)
              / (4.0 * max(cfg.f_workers, 1)))
    eta_t = torch.tensor(eta, dtype=torch.float32, device=own.device)
    bound2 = (eta_t * growth) ** 2 * n2g + 1e-6
    ok = (d2g <= bound2)[:, None]
    for c0, c1 in chunks:
        out[:, c0:c1] = torch.where(ok, models[idx, c0:c1], own[:, c0:c1])
    return out


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def make_init_fn(bundle, pcfg: ProtocolConfig, device=None):
    """Returns ``init(seed) -> ByzState``: one model drawn from a generator
    seeded with ``seed``, cast to the bundle's ``param_dtype`` and
    replicated into the ``[G, P]`` stack (one copy, leaf by leaf), a fresh
    run generator (``seed + 1``) and the optimizer's per-replica state."""
    dev = resolve(device)
    pdt = _dtype(bundle.cfg.param_dtype)
    opt = _optim.get(pcfg.optimizer)

    def init(seed: int) -> ByzState:
        p0 = bundle.init(torch.Generator(device=dev).manual_seed(seed))
        tree = FlatTree.from_params(p0)
        params = torch.empty((pcfg.n_groups, tree.size), dtype=pdt,
                             device=dev)
        for leaf, (off, size) in zip(tree.leaves(p0), tree.spans()):
            params[:, off:off + size] = leaf.reshape(-1).to(pdt)
        del p0
        return ByzState(params=params, t=0,
                        gen=torch.Generator(device=dev).manual_seed(seed + 1),
                        opt=opt.init(params), tree=tree)

    return init


def _buffer(bufs: dict, name: str, shape, dtype, device) -> torch.Tensor:
    """A scratch stack kept across steps (allocated once)."""
    b = bufs.get(name)
    if b is None or b.shape != tuple(shape) or b.dtype != dtype \
            or b.device != device:
        bufs.pop(name, None)
        b = bufs[name] = torch.empty(shape, dtype=dtype, device=device)
    return b


def make_scatter_step(bundle, pcfg: ProtocolConfig, lr_schedule,
                      with_attack: bool = False, delivery=None):
    """One ByzSGD scatter step ``(state, batch) -> state``; batch leaves
    ``[G, per_group, ...]`` (``[n_micro, G, ...]`` with micro-batches).

    ``delivery`` is a :class:`~repro_torch.core.quorum.UniformDelivery`
    (the default) or a :class:`~repro_torch.core.quorum.TraceDelivery`
    replaying quorum tables. The pulled view (in the model's ``act_dtype``,
    as the JAX step casts it) and the gradient stack are scratch buffers
    kept across steps."""
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
        eta = lr_schedule(state.t)

        # 1. worker pull -----------------------------------------------------
        models = params
        if with_attack and byz.server_attack:
            models = inject_models(params, byz, gen, tree=state.tree)
        pdt = act if params.dtype == torch.float32 else params.dtype
        pulled = _buffer(bufs, "pulled", params.shape, pdt, dev)
        if pcfg.pull == "roundrobin":
            _roundrobin_pull(models, params, state.t, eta, pcfg, pulled)
        else:
            pull_idx = delivery.pull_indices(gen, state.t, dev)
            masks = torch.zeros((G, G), dtype=torch.bool, device=dev)
            masks.scatter_(1, pull_idx.long(), True)
            masked_pull(models, masks, pcfg, out=pulled)
        del models

        # 2. per-group worker gradients --------------------------------------
        grads = _buffer(bufs, "grads", params.shape, xdt, dev)
        group_grads(bundle, state.tree, pulled, batch,
                    pcfg.grad_microbatches, grads)
        if with_attack and byz.worker_attack:
            inject_gradients(grads, byz, gen, tree=state.tree, inplace=True)

        # 3. gradient rule (MDA by default) per server over its quorum -------
        push_idx = delivery.push_indices(gen, state.t, dev)
        d2 = agg.rules.sqdists_from_gram(agg.tree_gram(grads))
        weights = quorum_weights(d2, push_idx, pcfg.f_workers, pcfg)
        g_hat = aggregate_gradients(grads, weights, pcfg, out=grads)

        # 4. local update ----------------------------------------------------
        new_params, new_opt = optimizer.update(g_hat, state.opt, params, eta)
        return state._replace(params=new_params, t=state.t + 1, opt=new_opt)

    return scatter_step


def make_gather_step(pcfg: ProtocolConfig, with_attack: bool = False,
                     delivery=None):
    """DMC: servers exchange replicas and apply the masked ``gather_gar``
    (Median by default) every T steps, in place on the replica stack."""
    G = pcfg.n_groups
    delivery = delivery or UniformDelivery(G, G, pcfg.q_workers,
                                           pcfg.q_servers)

    def gather_step(state: ByzState) -> ByzState:
        params, dev = state.params, state.params.device
        idx = delivery.gather_indices(state.gen, state.t, dev)
        masks = torch.zeros((G, G), dtype=torch.bool, device=dev)
        masks.scatter_(1, idx.long(), True)
        models = params
        if with_attack and pcfg.byz.server_attack:
            models = inject_models(params, pcfg.byz, state.gen,
                                   tree=state.tree)
        masked_pull(models, masks, pcfg, rule=pcfg.gather_gar, out=params)
        return state

    return gather_step


def make_train_step(bundle, pcfg: ProtocolConfig, lr_schedule,
                    with_attack: bool = False, delivery=None):
    """Scatter, then the DMC gather iff the advanced counter hits a
    multiple of T."""
    delivery = delivery or UniformDelivery(
        pcfg.n_groups, pcfg.n_groups, pcfg.q_workers, pcfg.q_servers)
    scatter = make_scatter_step(bundle, pcfg, lr_schedule, with_attack,
                                delivery)
    gather = make_gather_step(pcfg, with_attack, delivery)

    def train_step(state: ByzState, batch) -> ByzState:
        state = scatter(state, batch)
        return gather(state) if state.t % pcfg.T == 0 else state

    return train_step


# ---------------------------------------------------------------------------
# serving-side consolidation
# ---------------------------------------------------------------------------


def consolidate(params: torch.Tensor, pcfg: ProtocolConfig | None = None,
                chunk_bytes: int | None = None) -> torch.Tensor:
    """Median of the replicas -> one ``[P]`` serving model (DMC applied
    once, full delivery), streamed by column chunks (``pcfg``'s, or the
    default's without one)."""
    cb = chunk_bytes or (pcfg or ProtocolConfig).chunk_bytes
    G, P = params.shape
    out = torch.empty(P, dtype=params.dtype, device=params.device)
    for c0, c1 in _chunks(P, G, 4, cb):
        out[c0:c1] = agg.dispatch.cwise_median(params[:, c0:c1].float())
    return out


# ---------------------------------------------------------------------------
# ByzState <-> checkpoint leaves
# ---------------------------------------------------------------------------


def checkpoint_leaves(state: ByzState) -> list[tuple[str, Any]]:
    """``(name, value)`` of every leaf a checkpoint of ``state`` holds, in
    the names and order of a JAX ``ByzState`` checkpoint: ``.params/<path>``
    as ``[G, *shape]`` views of the stack, ``.t`` (int32), ``.key`` (uint32
    ``[2]``, the generator's seed: a JAX restore of a port checkpoint reads
    it and starts a new stream), AdamW's ``.opt/.m/<path>``,
    ``.opt/.v/<path>`` and ``.opt/.count``; then the port's own ``.gen``,
    the generator's state (uint8), which a JAX restore ignores."""
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
    """

    def __init__(self, bundle, pcfg: ProtocolConfig, lr_schedule, *,
                 delivery=None, with_attack: bool = False,
                 acc_fn: Callable | None = None,
                 eval_set: tuple | None = None, track_delta: bool = False,
                 metrics_every: int = 1, device=None):
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
        self.scatter = make_scatter_step(bundle, pcfg, lr_schedule,
                                         with_attack, self.delivery)
        self.gather = make_gather_step(pcfg, with_attack, self.delivery)

    def init_state(self, seed: int) -> ByzState:
        return make_init_fn(self.bundle, self.cfg, self.device)(seed)

    def _acc(self, state: ByzState):
        with torch.no_grad():
            return self.acc_fn(state.tree.unflatten(state.params[0]),
                               *self.eval_set)

    def run_epoch(self, state: ByzState, batches, bufs: dict, at: int):
        """``L`` steps over ``batches`` (leaves ``[L, G, ...]``), writing
        step ``at + i``'s metrics into ``bufs`` on the device."""
        h = self.cfg.n_groups - self.cfg.byz.n_byz_servers
        leaves = batches.values() if isinstance(batches, dict) else batches
        L = next(iter(leaves)).shape[0]
        for i in range(L):
            state = self.scatter(state, _index(batches, i))
            delta_pre = (coordinatewise_diameter_sum(state.params, h)
                         if self.track_delta else None)
            if state.t % self.cfg.T == 0:
                state = self.gather(state)
            k = at + i
            if self.acc_fn is not None and \
                    (state.t - 1) % self.metrics_every == 0:
                bufs["acc"][k] = self._acc(state)
            if self.track_delta:
                bufs["delta_pre"][k] = delta_pre
                bufs["delta"][k] = coordinatewise_diameter_sum(state.params,
                                                               h)
                bufs["l2_diam"][k] = l2_diameter(state.params, h)
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
                            *, fsdp: int = 1) -> int:
    """Modeled per-device cross-'rep' exchange (bytes) of one scatter
    step's payloads on a mesh: the masked Median pull all-gathers the
    ``[G, P]`` stack, ``(G-1)·P·itemsize``, and the ``[G, G] x [G, P]``
    aggregation moves as much again; with an 'fsdp' axis of size K each
    device moves 1/K of it. On one card the groups share the device and
    nothing crosses a link; the number says what the multi-GPU port's
    collectives will carry."""
    itemsize = _dtype(pcfg.exchange_dtype).itemsize
    G = pcfg.n_groups
    return 2 * (G - 1) * n_params * itemsize // fsdp

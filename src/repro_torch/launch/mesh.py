"""Rank meshes over ``torch.distributed`` — the port of ``repro.launch.mesh``.

A :class:`Mesh` is the reference's device mesh with ranks in place of
devices: axis names, a shape, this rank's coordinates (the rank's index in
the row-major order of the shape, as ``devices.reshape(shape)`` places
devices) and, for each axis longer than one, the process group of the line
of ranks along it through this rank. Every group is created on every rank
in one order (``torch.distributed.new_group`` must be), by
:func:`make_protocol_mesh` and :func:`make_byz_mesh`.

The protocol's view is ``('rep', 'fsdp', 'model')``: 'rep' indexes the
ranks that hold the G groups' replicas (G/rep rows of the flat ``[G, P]``
stack each), 'fsdp' splits a group's row into contiguous column ranges,
'model' (tensor parallelism: every model family,
``models.registry.MODEL_AXIS_FAMILIES``) gives each rank its block of
every leaf. The serve view is ``('data', 'model')``. Ranks lie in the
row-major order of the shape, so the 'model' lines are consecutive ranks.
With no process group initialised :func:`make_protocol_mesh` returns the
``(1, 1, 1)`` mesh, on which every collective is the identity: today's
single-card engine.

A mesh may leave ranks idle: :func:`make_segment_mesh`, the elastic
runner's mesh of one membership segment, places the reference's
``(rep, fsdp, 1)`` shape for G' groups on the world's first ``rep * K``
ranks (``repro.launch.mesh.make_protocol_mesh`` takes ``devices[:rep *
K]``), and the ranks after them sit the segment out. Such a rank is not a
member (``Mesh.member``): it has no coordinates, and each collective of
the mesh raises on it rather than wait for ranks that never come. The one
exception is :meth:`Mesh.share`, which rank 0 uses to hand a tensor to the
ranks past the mesh's end (a joiner's state at a membership boundary).

:class:`RankView` is one rank of a mesh without a world (the dry run's
production mesh, :func:`production_view`): its collectives take meta
tensors only and count as the real ones do.

Every collective of the protocol goes through the mesh's methods, which
count the bytes this rank sends, by tag (``Mesh.sent``): an all-gather of
n ranks sends ``(n - 1)`` times the local block, an all-to-all ``(n - 1) /
n`` of its buffer (the ring and pairwise models). Over gloo the tensors
stay where they are, CUDA ones included: gloo takes every collective used
here on CUDA tensors, so nothing is staged through the host.

A rank joins a run by :func:`init_distributed`: from the environment that
``torchrun`` sets, or from an explicit rank, world and rendezvous address.
Its device and backend follow :func:`repro_torch.device.rank_device` and
:func:`repro_torch.device.dist_backend`.
"""
from __future__ import annotations

import collections
import os
from contextlib import contextmanager

import numpy as np
import torch
import torch.distributed as dist

from ..device import dist_backend, rank_device, resolve

AXES = ("rep", "fsdp", "model")


class Mesh:
    """Axis names, shape, this rank's coordinates and the process group of
    each axis line through it (``None`` for an axis of size 1, or on a mesh
    built without groups)."""

    def __init__(self, axis_names, shape, *, rank: int = 0,
                 groups: dict | None = None, backend: str | None = None,
                 world: int | None = None):
        self.axis_names = tuple(axis_names)
        self.shape = tuple(int(n) for n in shape)
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axes {self.axis_names} vs shape {self.shape}")
        self.rank = int(rank)
        self.world = self.n_ranks if world is None else int(world)
        if self.world < self.n_ranks:
            raise ValueError(f"a {self.shape} mesh on a world of "
                             f"{self.world} ranks")
        # an idle rank (past the mesh's ranks) has no coordinates
        self.member = self.rank < self.n_ranks
        self.coords = (tuple(int(c) for c in
                             np.unravel_index(self.rank, self.shape))
                       if self.member else None)
        self.groups = dict(groups or {})
        self.backend = backend
        self.sent: collections.Counter = collections.Counter()

    def __repr__(self):
        at = f"at {self.coords}" if self.member else (
            f"idle, the mesh on ranks 0..{self.n_ranks - 1} of "
            f"{self.world}")
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, rank "
                f"{self.rank} {at}, {self.backend})")

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    @property
    def n_ranks(self) -> int:
        return int(np.prod(self.shape))

    def size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)

    def coord(self, axis: str) -> int:
        self._check_member()
        return self.coords[self.axis_names.index(axis)]

    @property
    def dp_size(self) -> int:
        """Total data-parallel slices R (pod x data; 'rep' x 'fsdp' on a
        protocol mesh)."""
        s = self.sizes
        if "rep" in s:
            return s["rep"] * s.get("fsdp", 1)
        return s.get("pod", 1) * s["data"]

    @property
    def model_size(self) -> int:
        return self.size("model")

    # -- collectives (identity on an axis of size 1) ------------------------
    def _check_member(self) -> None:
        if not self.member:
            raise RuntimeError(f"{self}: this rank sits the mesh out and "
                               "joins none of its collectives")

    def _group(self, axis: str):
        if self.size(axis) > 1 and axis not in self.groups:
            raise RuntimeError(f"{self}: no process group for axis {axis!r} "
                               "(build it with make_protocol_mesh or "
                               "make_byz_mesh)")
        return self.groups.get(axis)

    def all_gather(self, x: torch.Tensor, axis: str, tag: str):
        """``[b, ...]`` on each rank of the axis line -> ``[n * b, ...]``,
        the blocks in coordinate order."""
        self._check_member()
        n = self.size(axis)
        if n == 1:
            return x
        x = x.contiguous()
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=self._group(axis))
        self.sent[tag] += (n - 1) * x.numel() * x.element_size()
        return out

    def all_to_all(self, x: torch.Tensor, axis: str, tag: str):
        """``[n * b, ...]``: block j goes to coordinate j; returns ``[n * b,
        ...]`` whose block i came from coordinate i."""
        self._check_member()
        n = self.size(axis)
        if n == 1:
            return x
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self._group(axis))
        self.sent[tag] += (n - 1) * (x.numel() // n) * x.element_size()
        return out

    def broadcast(self, x: torch.Tensor, axis: str, tag: str, src: int = 0):
        """``x`` of the line's coordinate ``src``, on every rank of the line
        (in place)."""
        self._check_member()
        n = self.size(axis)
        if n == 1:
            return x
        group = self._group(axis)
        src = dist.get_global_rank(group, src)
        dist.broadcast(x, src, group=group)
        if self.rank == src:
            self.sent[tag] += (n - 1) * x.numel() * x.element_size()
        return x

    def barrier(self) -> None:
        """A barrier of the mesh's ranks (of the world when the mesh spans
        it)."""
        self._check_member()
        if self.n_ranks > 1:
            dist.barrier(group=self.groups.get("members"))

    def share(self, x: torch.Tensor | None, upto: int, tag: str):
        """Rank 0's ``x`` on the world's ranks ``n_ranks .. upto - 1``, the
        ranks past the mesh's end (in place there; ``x`` is returned as it
        is on every other rank, where it may be ``None``). Every rank of the
        world calls it, idle ones included: the process group of rank 0
        and those ranks is made on first use, and ``new_group`` is
        collective over the world. Rank 0 counts ``upto - n_ranks`` copies
        of ``x`` under ``tag``."""
        if upto <= self.n_ranks:
            return x
        line = [0] + list(range(self.n_ranks, upto))
        group = self.groups.get(("share", upto))
        if group is None:
            group = self.groups[("share", upto)] = dist.new_group(line)
        if self.rank not in line:
            return x
        dist.broadcast(x, 0, group=group)
        if self.rank == 0:
            self.sent[tag] += (len(line) - 1) * x.numel() * x.element_size()
        return x


class RankView(Mesh):
    """One rank of a mesh without a world: the port's counterpart of the
    reference's fake host devices (``repro/launch/dryrun.py:2``). It has
    the mesh's axes, shape and this rank's coordinates, and no process
    group; its collectives take ``meta`` tensors only (shapes: the dry
    run) and return meta outputs of the shapes a real collective gives,
    counting the bytes this rank would send by tag exactly as
    :class:`Mesh` does (``sent``), and the calls by tag (``calls``). A
    tensor with storage is refused, so a view never stands in for a real
    collective."""

    def __init__(self, axis_names, shape, *, rank: int = 0):
        super().__init__(axis_names, shape, rank=rank, backend="view")
        self.calls: collections.Counter = collections.Counter()

    def view(self, axis_names, shape) -> "RankView":
        """The same rank (row-major index) on another factoring of the
        mesh's ranks."""
        if int(np.prod(shape)) != self.n_ranks:
            raise ValueError(f"a {tuple(shape)} view of {self.n_ranks} "
                             "ranks")
        return RankView(axis_names, shape, rank=self.rank)

    @staticmethod
    def _meta(x: torch.Tensor, what: str) -> None:
        if not x.is_meta:
            raise ValueError(f"RankView.{what}: takes meta tensors only (a "
                             f"rank view has no world); got {x.device}")

    def all_gather(self, x, axis, tag):
        self._meta(x, "all_gather")
        n = self.size(axis)
        if n == 1:
            return x
        self.sent[tag] += (n - 1) * x.numel() * x.element_size()
        self.calls[tag] += 1
        return x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))

    def all_to_all(self, x, axis, tag):
        self._meta(x, "all_to_all")
        n = self.size(axis)
        if n == 1:
            return x
        self.sent[tag] += (n - 1) * (x.numel() // n) * x.element_size()
        self.calls[tag] += 1
        return torch.empty_like(x)

    def broadcast(self, x, axis, tag, src: int = 0):
        self._meta(x, "broadcast")
        n = self.size(axis)
        if n == 1:
            return x
        self.calls[tag] += 1
        if self.coord(axis) == src:
            self.sent[tag] += (n - 1) * x.numel() * x.element_size()
        return x

    def barrier(self) -> None:
        return None


def production_view(*, multi_pod: bool = False, rank: int = 0) -> RankView:
    """Rank ``rank`` of the production mesh, 16 x 16 ('data', 'model') or
    2 x 16 x 16 ('pod', 'data', 'model'), without a world (the dry run's
    mesh; :func:`make_production_mesh` needs 256 or 512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return RankView(axes, shape, rank=rank)


def _world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(shape, axis_names) -> Mesh:
    """A mesh of ``shape`` over every rank of the initialised world (one
    rank without a process group), without process groups: the base a
    protocol or serve view is carved from."""
    rank, world = _world()
    if int(np.prod(shape)) != world:
        raise ValueError(f"a {tuple(shape)} mesh needs {int(np.prod(shape))} "
                         f"ranks; this world has {world}")
    return Mesh(axis_names, shape, rank=rank,
                backend=dist.get_backend() if dist.is_initialized() else None)


def _with_groups(axis_names, shape, *, part: bool = False) -> Mesh:
    """A mesh over the world (with ``part``, over its first ranks) with one
    process group per line of every axis longer than one and, when ranks
    are left idle, one of the mesh's ranks (``"members"``), created in the
    same order on every rank, idle ones included."""
    if part:
        rank, world = _world()
        mesh = Mesh(axis_names, shape, rank=rank, world=world,
                    backend=dist.get_backend() if dist.is_initialized()
                    else None)
    else:
        mesh = make_mesh(shape, axis_names)
    ranks = np.arange(mesh.n_ranks).reshape(mesh.shape)
    for i, axis in enumerate(mesh.axis_names):
        if mesh.shape[i] == 1:
            continue
        lines = np.moveaxis(ranks, i, -1).reshape(-1, mesh.shape[i])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if mesh.rank in line:
                mesh.groups[axis] = g
    if mesh.n_ranks < mesh.world:
        mesh.groups["members"] = dist.new_group(list(range(mesh.n_ranks)))
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The spec's production mesh: 16 x 16 ('data', 'model'), or 2 x 16 x
    16 ('pod', 'data', 'model'): 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    _, world = _world()
    if world != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks; "
                         f"this world has {world}")
    return make_mesh(shape, axes)


def make_byz_mesh(mesh: Mesh, n_groups: int) -> Mesh:
    """The ('rep', 'fsdp', 'model') view over ``mesh``'s ranks: G groups of
    R / G consecutive data slices each, every slice M 'model' ranks (of a
    :class:`RankView`, the same rank's view)."""
    R, M = mesh.dp_size, mesh.model_size
    if R % n_groups:
        raise ValueError(f"n_groups={n_groups} must divide dp slices R={R}")
    if isinstance(mesh, RankView):
        return mesh.view(AXES, (n_groups, R // n_groups, M))
    return _with_groups(AXES, (n_groups, R // n_groups, M))


def protocol_mesh_shape(n_groups: int, world: int,
                        fsdp: int | None = None,
                        model: int = 1) -> tuple[int, int, int]:
    """The reference's rule (``repro.launch.mesh.make_protocol_mesh``):
    'model' takes ``model`` ranks of each slice, 'rep' is the largest
    divisor of G that the ``world / model`` slices can host, the slices
    left over form 'fsdp' (``fsdp`` overrides it)."""
    if world < 1 or world % model:
        raise ValueError(f"no protocol mesh of model={model} on {world} "
                         "ranks")
    slices = world // model
    rep = max(d for d in range(1, min(n_groups, slices) + 1)
              if n_groups % d == 0)
    K = slices // rep if fsdp is None else fsdp
    if rep * K > slices:
        raise ValueError(f"fsdp={K} needs {rep * K * model} ranks for "
                         f"rep={rep}, have {world}")
    return rep, K, model


def make_protocol_mesh(n_groups: int, world: int | None = None, *,
                       fsdp: int | None = None, model: int = 1) -> Mesh:
    """The ('rep', 'fsdp', 'model') mesh of a G-group protocol run over the
    initialised world (:func:`protocol_mesh_shape`); without a process
    group, the ``(1, 1, 1)`` mesh. Every rank must hold a place in it: a
    world the rule does not use whole (6 ranks at G = 4 use 4) is refused,
    where the reference leaves devices idle (as the elastic runner's
    segments do: :func:`make_segment_mesh`)."""
    _, have = _world()
    world = have if world is None else world
    if world != have:
        raise ValueError(f"make_protocol_mesh: world={world}, but "
                         f"{have} ranks are initialised")
    shape = protocol_mesh_shape(n_groups, world, fsdp, model)
    used = shape[0] * shape[1] * shape[2]
    if used != world:
        raise ValueError(f"G={n_groups} on {world} ranks places a {shape} "
                         f"mesh on {used} of them; launch {used} ranks")
    return _with_groups(AXES, shape)


def segment_ranks(n_groups: int, world: int) -> np.ndarray:
    """The ranks of the elastic runner's G-group mesh on ``world`` ranks,
    ``[rep, fsdp, 1]``: the reference's placement
    (``repro.launch.mesh.make_protocol_mesh`` reshapes ``devices[:rep *
    K]``), ranks in place of devices. The ranks after them are idle."""
    shape = protocol_mesh_shape(n_groups, world)
    return np.arange(int(np.prod(shape))).reshape(shape)


def make_segment_mesh(n_groups: int) -> Mesh:
    """The ('rep', 'fsdp', 'model') mesh of one membership segment of G'
    groups over the initialised world (:func:`segment_ranks`): where
    :func:`make_protocol_mesh` refuses a world its shape does not use
    whole, this leaves the ranks past ``rep * K`` idle, as the reference
    leaves devices idle. Every rank of the world calls it (the process
    groups are made on all of them); without a process group, the ``(1, 1,
    1)`` mesh."""
    _, world = _world()
    return _with_groups(AXES, segment_ranks(n_groups, world).shape,
                        part=True)


def make_serve_mesh(mesh: Mesh) -> Mesh:
    """('data', 'model') flat view for serving (no replica axis), with the
    process groups of its lines (of a :class:`RankView`, the same rank's
    view)."""
    shape = (mesh.dp_size, mesh.model_size)
    if isinstance(mesh, RankView):
        return mesh.view(("data", "model"), shape)
    return _with_groups(("data", "model"), shape)


def launch_mesh(spec: str | None, device, cfg) -> tuple[torch.device, int,
                                                      int]:
    """(this rank's device, D, M) of a launcher's ``--mesh DxM`` over the
    ranks ``torchrun`` started (default: the world's size x 1). The
    model's family must take M ranks on 'model'
    (:func:`repro_torch.models.registry.check_model_axis`) and D x M must
    be the world; a rank of a run with more than one joins it
    (:func:`init_distributed`). Exits with the reason otherwise."""
    from ..models.registry import check_model_axis
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    d, m = ((int(x) for x in spec.split("x")) if spec else (world, 1))
    try:
        check_model_axis(cfg, m)
    except NotImplementedError as err:
        raise SystemExit(f"--mesh {spec}: {err}") from None
    if d * m != world:
        raise SystemExit(f"--mesh {d}x{m} needs {d * m} ranks (torchrun "
                         f"--standalone --nproc-per-node {d * m}); this run "
                         f"has {world}")
    dev = (init_distributed(device) if world > 1 or dist.is_initialized()
           else resolve(device))
    return dev, d, m


@contextmanager
def leaving_group():
    """Around a launcher's run: when it joins a process group (by
    :func:`launch_mesh`), leave it on every exit — after a barrier when
    the run ends normally, at once when it raises — so no rank's
    interpreter exit tears down a transport a peer still uses. A group
    that was up before (a caller's) is left to its caller, and a refusal
    raised before joining leaves nothing."""
    own = not dist.is_initialized()
    try:
        yield
    except BaseException:
        if own and dist.is_initialized():
            dist.destroy_process_group()
        raise
    if own and dist.is_initialized():
        try:
            dist.barrier()
        finally:
            dist.destroy_process_group()


def init_distributed(device=None, *, rank: int | None = None,
                     world: int | None = None,
                     init_method: str = "env://") -> torch.device:
    """Join a ``torch.distributed`` run and return this rank's device.

    Rank, world and local rank come from the environment ``torchrun`` sets
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, with ``MASTER_ADDR`` /
    ``MASTER_PORT`` behind ``env://``) unless given (then the local rank is
    the rank: one host). The device follows ``rank_device`` and the backend
    ``dist_backend``; rank 0 prints the choice once. An initialised group
    is kept, and only the device is resolved."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world = int(env.get("WORLD_SIZE", 1)) if world is None else world
    local = int(env.get("LOCAL_RANK", rank))
    dev = rank_device(device, local)
    if dist.is_initialized():
        return dev
    backend = dist_backend(dev, world)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    if rank == 0:
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        print(f"[mesh] {world} ranks on {dev.type} ({cards} cards): "
              f"backend {backend}", flush=True)
    return dev

"""`ReplicaPool` — n independent parameter replicas behind one read surface
(port of ``repro.serve.replica``).

The pool holds a nested dict whose leaves are ``[R, ...]`` replica stacks,
as the JAX pool does, plus the declared tolerance f and a host-side
liveness mask that quorum ejections flip. Replica sources: one trusted
model broadcast (:meth:`ReplicaPool.from_params`), a live ``[R, ...]``
stack (:meth:`ReplicaPool.from_stacked`), or a replica-stacked ByzSGD
checkpoint (:meth:`ReplicaPool.from_checkpoint`, the replica count read
from its manifest by :func:`checkpoint_groups`).

On a serve mesh (tensor parallelism, the 'model' axis) a pool holds each
rank's blocks of every replica's leaves (:meth:`ReplicaPool.shard`, by
:func:`repro_torch.launch.steps.serve_param_sharding`'s 'model' dims):
the median and the other reads are coordinate-wise, so they run on the
blocks as they are.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from .. import agg
from ..checkpoint import checkpointer as ck
from ..core.attacks import ByzantineSpec, inject_models


def checkpoint_groups(ckpt_dir: str, step: int | None = None
                      ) -> tuple[int, int]:
    """(step, n_replicas) of a replica-stacked checkpoint (the latest step
    by default), read from the manifest: any ``params`` leaf's leading dim
    is the replica count."""
    if step is None:
        step = ck.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir!r}")
    for name, info in ck.read_manifest(ckpt_dir, step)["leaves"].items():
        if "params" in name.split("/")[0] and info["shape"]:
            return step, int(info["shape"][0])
    raise ValueError(f"checkpoint {ckpt_dir!r} step {step} has no "
                     "replica-stacked params leaves")


def leaves(tree):
    """The tensors of a nested dict, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


@dataclass
class ReplicaPool:
    """n parameter replicas (leaves ``[R, ...]``) + the declared Byzantine
    tolerance f and a host-side liveness mask."""
    params: Any
    f: int = 0
    active: np.ndarray = field(default=None)  # [R] bool
    sharded: bool = False   # the leaves are a serve mesh's blocks

    def __post_init__(self):
        leaves_ = list(leaves(self.params))
        if not leaves_:
            raise ValueError("ReplicaPool needs a non-empty params tree")
        R = leaves_[0].shape[0]
        if any(l.shape[0] != R for l in leaves_):
            raise ValueError("all param leaves must share the leading "
                             "replica axis")
        if self.active is None:
            self.active = np.ones(R, bool)
        self.active = np.asarray(self.active, bool)
        if self.active.shape != (R,):
            raise ValueError(f"active mask must be [R={R}], "
                             f"got {self.active.shape}")
        if self.f < 0 or R < 2 * self.f + 1:
            raise ValueError(f"quorum reads need n >= 2f+1 replicas "
                             f"(got n={R}, f={self.f})")

    # -- shape -------------------------------------------------------------
    @property
    def n_replicas(self) -> int:
        return next(leaves(self.params)).shape[0]

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    @property
    def quorum_floor(self) -> int:
        """Graceful-degradation floor: ejections never go below 2f+1."""
        return 2 * self.f + 1

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_params(cls, params, n_replicas: int, f: int = 0) -> "ReplicaPool":
        """Broadcast one trusted model to n bit-identical replicas. The stack
        is a broadcast view: the n replicas share the one model's memory
        until :meth:`corrupt` or :meth:`reactivate` writes new ones."""
        stacked = tree_map(
            lambda l: l.unsqueeze(0).expand((n_replicas,) + l.shape), params)
        return cls(params=stacked, f=f)

    @classmethod
    def from_stacked(cls, stacked, f: int = 0,
                     active: np.ndarray | None = None) -> "ReplicaPool":
        """Adopt an existing ``[R, ...]`` stack (e.g. ``state.tree.unflatten
        (state.params)`` of a live protocol state)."""
        return cls(params=stacked, f=f, active=active)

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, init_params=None, *,
                        step: int | None = None, f: int = 0,
                        device=None) -> "ReplicaPool":
        """Restore a replica-stacked ByzSGD checkpoint (latest step by
        default) onto ``device`` (the GPU unless ``"cpu"`` is asked). The
        replica count and the param tree come from the manifest; the leaves
        are ``[R, *shape]`` views of the one restored ``[R, P]`` stack.
        ``init_params(gen) -> single-replica params`` (``bundle.init`` or an
        MLP init), when given, is called once on the CPU to check that the
        checkpoint holds that model."""
        from ..core.protocol import ByzState, tree_from_manifest
        from ..core.simulator import FlatTree
        step, _ = checkpoint_groups(ckpt_dir, step)
        tree = tree_from_manifest(ck.read_manifest(ckpt_dir, step)["leaves"])
        if init_params is not None:
            want = FlatTree.from_params(
                init_params(torch.Generator().manual_seed(0)))
            have = list(zip(tree.paths, tree.shapes))
            if have != list(zip(want.paths, want.shapes)):
                raise ValueError(
                    f"checkpoint {ckpt_dir!r} step {step} holds another "
                    f"model than init_params: {have}")
        like = ByzState(params=None, t=0, gen=None, tree=tree)
        state, _ = ck.restore(ckpt_dir, step, like, device, params_only=True)
        return cls(params=tree.unflatten(state.params), f=f)

    def shard(self, specs: list, mesh) -> "ReplicaPool":
        """This rank's blocks of every replica: ``specs`` holds, per leaf
        in the tree's leaf order (sorted keys), ``{"model": dim}`` of the
        leaf without its replica axis
        (:func:`repro_torch.launch.steps.serve_param_sharding`). A
        broadcast stack (:meth:`from_params`) stays one block broadcast
        to R; any other block is copied, so the whole pool can be
        freed."""
        from ..launch.steps import block
        it = iter(specs)

        def cut(l):
            spec = {a: d + 1 for a, d in next(it).items() if a == "model"}
            if not spec:
                return l
            if l.stride(0) == 0:
                one = block(l[:1], spec, mesh).clone()
                return one.expand((l.shape[0],) + one.shape[1:])
            return block(l, spec, mesh).clone()

        def walk(t):
            if isinstance(t, dict):
                return {k: walk(t[k]) for k in sorted(t)}
            return cut(t)

        return ReplicaPool(params=walk(self.params), f=self.f,
                           active=self.active.copy(), sharded=True)

    # -- reads -------------------------------------------------------------
    def single(self, i: int = 0):
        """One replica's params (views)."""
        return tree_map(lambda l: l[i], self.params)

    def replicas(self) -> list:
        """Every replica's params, in order (views)."""
        return [self.single(i) for i in range(self.n_replicas)]

    def consolidated(self):
        """Median-of-active-replicas -> one serving model (the DMC rule
        applied at read time; the median kernel on the card)."""
        idx = torch.as_tensor(np.flatnonzero(self.active))

        def med(l):
            x = l.index_select(0, idx.to(l.device))
            out = agg.dispatch.cwise_median(x.reshape(x.shape[0], -1).float())
            return out.reshape(l.shape[1:]).to(l.dtype)

        return tree_map(med, self.params)

    # -- fault injection / membership --------------------------------------
    def corrupt(self, spec: ByzantineSpec,
                gen: torch.Generator | None = None) -> "ReplicaPool":
        """A new pool with the last ``spec.n_byz_servers`` replicas replaced
        by the named model attack (``gen`` feeds the stochastic attacks and
        lives on the params' device)."""
        if spec.n_byz_servers > self.f:
            raise ValueError(f"corrupting {spec.n_byz_servers} replicas "
                             f"exceeds the declared tolerance f={self.f}")
        return ReplicaPool(params=inject_models(self.params, spec, gen),
                           f=self.f, active=self.active.copy(),
                           sharded=self.sharded)

    def deactivate(self, i: int) -> bool:
        """Eject replica i unless that would break the 2f+1 read quorum.
        Returns True when the ejection took effect."""
        if not self.active[i]:
            return False
        if self.n_active - 1 < self.quorum_floor:
            return False
        self.active[i] = False
        return True

    def reactivate(self, i: int, healed=None) -> bool:
        """Re-admit an ejected replica, overwritten first with ``healed``
        (default :meth:`consolidated`, the median of the active replicas),
        so a corrupted model never rejoins carrying its corruption. Returns
        False when the replica is already active."""
        if self.active[i]:
            return False
        if healed is None:
            healed = self.consolidated()
        self.params = tree_map(
            lambda l, h: torch.cat([l[:i], h.to(l.dtype)[None], l[i + 1:]]),
            self.params, healed)
        self.active[i] = True
        return True

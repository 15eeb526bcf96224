"""`ReplicaPool` — n independent parameter replicas behind one read surface
(port of ``repro.serve.replica``; restoring a pool from a ByzSGD checkpoint
waits for the checkpointer port).

The pool holds a nested dict whose leaves are ``[R, ...]`` replica stacks,
as the JAX pool does, plus the declared tolerance f and a host-side
liveness mask that quorum ejections flip.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..agg import rules
from ..core.attacks import ByzantineSpec, inject_models


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
        """Adopt an existing ``[R, ...]`` stack."""
        return cls(params=stacked, f=f, active=active)

    # -- reads -------------------------------------------------------------
    def single(self, i: int = 0):
        """One replica's params (views)."""
        return tree_map(lambda l: l[i], self.params)

    def replicas(self) -> list:
        """Every replica's params, in order (views)."""
        return [self.single(i) for i in range(self.n_replicas)]

    def consolidated(self):
        """Median-of-active-replicas -> one serving model (the DMC rule
        applied at read time)."""
        idx = torch.as_tensor(np.flatnonzero(self.active))
        return tree_map(
            lambda l: rules.median_stack(
                l.index_select(0, idx.to(l.device)).float()).to(l.dtype),
            self.params)

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
                           f=self.f, active=self.active.copy())

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

"""Fault injectors: crash/recovery, partitions, loss/duplication, slow churn.

All injectors are declarative (frozen dataclasses of time windows and rates)
and are consulted by the cluster engine at send/delivery time. They compose
through :class:`FaultPlan`. Times are virtual milliseconds.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

INF = float("inf")


@dataclass(frozen=True)
class CrashWindow:
    node: int
    t_down: float
    t_up: float = INF  # INF = crash without recovery


@dataclass(frozen=True)
class CrashPlan:
    """Fail-stop crash/recovery schedule. A down node neither sends, computes,
    nor delivers; in-flight messages to it are dropped at arrival."""
    windows: tuple[CrashWindow, ...] = ()

    def is_up(self, node: int, t: float) -> bool:
        return all(not (w.node == node and w.t_down <= t < w.t_up)
                   for w in self.windows)

    def next_up(self, node: int, t: float) -> float:
        """Earliest time >= t at which ``node`` is up (may be inf)."""
        while True:
            for w in self.windows:
                if w.node == node and w.t_down <= t < w.t_up:
                    t = w.t_up
                    break
            else:
                return t


@dataclass(frozen=True)
class PartitionWindow:
    t0: float
    t1: float
    groups: tuple[tuple[int, ...], ...]  # disjoint node groups; cross-group cut

    def blocks(self, src: int, dst: int, t: float) -> bool:
        if not (self.t0 <= t < self.t1):
            return False
        gs = gd = -1
        for gi, g in enumerate(self.groups):
            if src in g:
                gs = gi
            if dst in g:
                gd = gi
        # nodes not named in any group communicate freely
        return gs >= 0 and gd >= 0 and gs != gd


@dataclass(frozen=True)
class PartitionPlan:
    windows: tuple[PartitionWindow, ...] = ()

    def blocks(self, src: int, dst: int, t: float) -> bool:
        return any(w.blocks(src, dst, t) for w in self.windows)


@dataclass(frozen=True)
class LossyLink:
    """IID message drop and duplication. A duplicated message is re-delivered
    once more after ``dup_extra_ms`` additional delay."""
    p_drop: float = 0.0
    p_dup: float = 0.0
    dup_extra_ms: float = 1.0

    def drops(self, rng: np.random.Generator) -> bool:
        return self.p_drop > 0 and rng.random() < self.p_drop

    def duplicates(self, rng: np.random.Generator) -> bool:
        return self.p_dup > 0 and rng.random() < self.p_dup


@dataclass(frozen=True)
class SlowChurn:
    """Rotating set of slow nodes: every ``period_ms`` the window of
    ``n_slow`` consecutive node ids (mod ``n_nodes``) advances by ``n_slow``.
    A slow *sender or receiver* multiplies message latency by ``factor`` —
    persistent per-node slowness, unlike BimodalStraggler's per-message tail."""
    n_nodes: int = 0
    n_slow: int = 0
    factor: float = 10.0
    period_ms: float = 50.0
    only: tuple[int, ...] = ()  # restrict churn to these node ids (e.g. Byz)

    def is_slow(self, node: int, t: float) -> bool:
        if self.n_slow <= 0 or self.n_nodes <= 0:
            return False
        if self.only:
            return node in self.only
        r = int(t // self.period_ms)
        lo = (r * self.n_slow) % self.n_nodes
        off = (node - lo) % self.n_nodes
        return off < self.n_slow

    def scale(self, src: int, dst: int, t: float) -> float:
        return self.factor if (self.is_slow(src, t) or self.is_slow(dst, t)) \
            else 1.0


@dataclass(frozen=True)
class FaultPlan:
    crashes: CrashPlan = field(default_factory=CrashPlan)
    partitions: PartitionPlan = field(default_factory=PartitionPlan)
    lossy: LossyLink = field(default_factory=LossyLink)
    churn: SlowChurn = field(default_factory=SlowChurn)

    def is_up(self, node: int, t: float) -> bool:
        return self.crashes.is_up(node, t)

    def next_up(self, node: int, t: float) -> float:
        return self.crashes.next_up(node, t)

    def blocked(self, src: int, dst: int, t: float) -> bool:
        return self.partitions.blocks(src, dst, t)

    def latency_scale(self, src: int, dst: int, t: float) -> float:
        return self.churn.scale(src, dst, t)

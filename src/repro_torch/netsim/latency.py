"""Per-link latency models (milliseconds) and compute-time models.

A :class:`LatencyModel` maps (rng, src, dst) -> one-way network delay for a
single message. Models are frozen dataclasses so scenarios stay hashable and
printable; all randomness comes from the generator passed in (owned by the
event loop), keeping runs bit-deterministic per seed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class LatencyModel(Protocol):
    def sample(self, rng: np.random.Generator, src: int, dst: int) -> float:
        ...


@dataclass(frozen=True)
class FixedLatency:
    """Constant one-way delay — the degenerate 'uniform cluster' link."""
    ms: float = 1.0

    def sample(self, rng, src, dst) -> float:
        del rng, src, dst
        return self.ms


@dataclass(frozen=True)
class LognormalLatency:
    """Median ``median_ms`` with multiplicative jitter exp(N(0, sigma)) —
    the standard well-behaved datacenter link."""
    median_ms: float = 1.0
    sigma: float = 0.25

    def sample(self, rng, src, dst) -> float:
        del src, dst
        return float(self.median_ms * np.exp(self.sigma * rng.standard_normal()))


@dataclass(frozen=True)
class ParetoLatency:
    """Heavy-tailed delay floor_ms * (1 + Pareto(alpha)): most messages are
    fast, a power-law tail models stragglers/retransmits. alpha <= 2 gives
    infinite variance — the adversarial regime for quorum systems."""
    floor_ms: float = 0.5
    alpha: float = 1.8

    def sample(self, rng, src, dst) -> float:
        del src, dst
        return float(self.floor_ms * (1.0 + rng.pareto(self.alpha)))


@dataclass(frozen=True)
class BimodalStraggler:
    """With probability ``p_slow`` a message takes ``slow_factor`` times the
    base delay (GC pause / queueing spike), else the base delay alone."""
    base: LatencyModel = LognormalLatency()
    slow_factor: float = 20.0
    p_slow: float = 0.05

    def sample(self, rng, src, dst) -> float:
        d = self.base.sample(rng, src, dst)
        if rng.random() < self.p_slow:
            d *= self.slow_factor
        return d


@dataclass(frozen=True)
class TopologyLatency:
    """Rack/datacenter topology: nodes live in zones; a zone-pair RTT matrix
    sets the base delay and ``jitter`` multiplies it. ``zone_of[i]`` is node
    i's zone; nodes beyond the tuple wrap around (i % len)."""
    zone_of: tuple[int, ...]
    zone_ms: tuple[tuple[float, ...], ...]  # [n_zones, n_zones] one-way base
    jitter: LatencyModel = LognormalLatency(1.0, 0.1)

    def sample(self, rng, src, dst) -> float:
        zs = self.zone_of[src % len(self.zone_of)]
        zd = self.zone_of[dst % len(self.zone_of)]
        return self.zone_ms[zs][zd] * self.jitter.sample(rng, src, dst)


@dataclass(frozen=True)
class ComputeTime:
    """Lognormal task duration (gradient computation, server update)."""
    mean_ms: float = 5.0
    sigma: float = 0.2

    def sample(self, rng: np.random.Generator) -> float:
        return float(self.mean_ms * np.exp(
            self.sigma * rng.standard_normal() - 0.5 * self.sigma ** 2))


def transfer_ms(nbytes: int, bandwidth_gbps: float | None) -> float:
    """Serialization delay of a payload on a link, 0 if bandwidth unmodelled."""
    if not bandwidth_gbps:
        return 0.0
    return nbytes * 8.0 / (bandwidth_gbps * 1e9) * 1e3

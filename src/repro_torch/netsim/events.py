"""Seeded discrete-event core: virtual clock + event heap.

Determinism contract: given the same seed and the same schedule of calls, a
simulation is bit-identical. Two ingredients enforce this:

  * ties in the event heap break on a monotonically increasing sequence
    number (scheduling order), never on callback identity;
  * all randomness flows from :class:`EventLoop` streams created by
    :meth:`EventLoop.stream`, which derive child PRNGs from (seed, label) —
    independent of scheduling interleavings.
"""
from __future__ import annotations

import heapq
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np


@dataclass(order=True)
class Event:
    time: float
    seq: int
    fn: Callable = field(compare=False)
    args: tuple = field(compare=False, default=())


class EventLoop:
    """Minimal event engine with a float virtual clock (milliseconds)."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.now = 0.0
        self._heap: list[Event] = []
        self._seq = 0
        self.processed = 0

    # -- scheduling --------------------------------------------------------
    def at(self, time: float, fn: Callable, *args: Any) -> None:
        """Schedule ``fn(*args)`` at absolute virtual ``time`` (clamped so the
        clock never moves backwards)."""
        heapq.heappush(self._heap,
                       Event(max(float(time), self.now), self._seq, fn, args))
        self._seq += 1

    def after(self, delay: float, fn: Callable, *args: Any) -> None:
        self.at(self.now + max(float(delay), 0.0), fn, *args)

    # -- execution ---------------------------------------------------------
    def run(self, until: float | None = None, max_events: int = 5_000_000) -> int:
        """Drain the heap (or run up to virtual time ``until``). Returns the
        number of events processed in this call."""
        n0 = self.processed
        while self._heap:
            if until is not None and self._heap[0].time > until:
                break
            ev = heapq.heappop(self._heap)
            self.now = ev.time
            ev.fn(*ev.args)
            self.processed += 1
            if self.processed - n0 > max_events:
                raise RuntimeError(f"event budget exceeded ({max_events})")
        return self.processed - n0

    @property
    def pending(self) -> int:
        return len(self._heap)

    # -- deterministic child PRNG streams ----------------------------------
    def stream(self, label: str) -> np.random.Generator:
        """Independent generator derived from (loop seed, label)."""
        return np.random.default_rng(
            [self.seed & 0xFFFFFFFF, zlib.crc32(label.encode())])

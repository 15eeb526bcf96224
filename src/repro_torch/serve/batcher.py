"""Request queue + continuous batching over the prefill/decode loop.

The decode hot path runs a *fixed* number of slots (static shapes, one
compiled executable); requests flow through the slots continuously:

  * **admission** — ``submit`` appends to a bounded queue (beyond
    ``max_queue`` the request is rejected at the door, the standard
    overload response);
  * **refill** — whenever a slot frees up (request finished, deadline hit)
    the next queued request is prefilled into it while the other slots keep
    decoding — no barrier between requests (continuous batching);
  * **deadlines** — each request carries a wall-clock budget; a request that
    exceeds it is truncated and reported with ``status="deadline"``.

The batcher is pure bookkeeping (host-side); the service owns the device
loop and calls :meth:`fill` / :meth:`finish` around it.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class Request:
    """One generation request and its lifecycle record."""
    rid: int
    prompt: list[int]
    max_new: int = 32
    deadline_ms: float | None = None     # wall budget from admission
    # -- lifecycle (filled by the batcher/service) -------------------------
    slot: int | None = None
    out_tokens: list[int] = field(default_factory=list)
    status: str = "queued"               # queued|running|done|deadline|rejected
    t_submit: float = field(default_factory=time.perf_counter)
    t_start: float | None = None
    t_done: float | None = None

    @property
    def latency_s(self) -> float | None:
        return None if self.t_done is None else self.t_done - self.t_submit

    @property
    def deadline_met(self) -> bool:
        return self.status == "done"

    def past_deadline(self, now: float) -> bool:
        return (self.deadline_ms is not None
                and (now - self.t_submit) * 1e3 > self.deadline_ms)


class ContinuousBatcher:
    """Slot allocator + admission queue (see module docstring)."""

    def __init__(self, n_slots: int, max_queue: int | None = None):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self.max_queue = max_queue
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * n_slots
        self._rid = 0
        self._slot_used = [False] * n_slots
        self.rejected = 0
        self.refills = 0

    # -- admission ---------------------------------------------------------
    def submit(self, prompt, max_new: int = 32,
               deadline_ms: float | None = None) -> Request:
        """Admit a request (or mark it rejected when the queue is full)."""
        req = Request(rid=self._rid, prompt=list(map(int, prompt)),
                      max_new=max_new, deadline_ms=deadline_ms)
        self._rid += 1
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            req.status = "rejected"
            self.rejected += 1
            return req
        self.queue.append(req)
        return req

    # -- slot management ---------------------------------------------------
    def fill(self) -> list[Request]:
        """Move queued requests into free slots; returns the newly placed
        requests (the service prefills exactly these)."""
        placed = []
        for s in range(self.n_slots):
            if self.slots[s] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            req.slot, req.status = s, "running"
            req.t_start = time.perf_counter()
            self.slots[s] = req
            placed.append(req)
            if self._slot_used[s]:           # slot turned over mid-run
                self.refills += 1
            self._slot_used[s] = True
        return placed

    def finish(self, req: Request, status: str = "done") -> None:
        """Release a request's slot and stamp its completion."""
        req.status = status
        req.t_done = time.perf_counter()
        if req.slot is not None:
            self.slots[req.slot] = None
            req.slot = None

    def expire(self) -> list[Request]:
        """Truncate running requests past their deadline (freeing slots)."""
        now = time.perf_counter()
        hit = [r for r in self.slots if r is not None and r.past_deadline(now)]
        for r in hit:
            self.finish(r, status="deadline")
        return hit

    # -- views -------------------------------------------------------------
    @property
    def running(self) -> list[Request]:
        return [r for r in self.slots if r is not None]

    @property
    def pending(self) -> int:
        return len(self.queue)

    @property
    def idle(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)

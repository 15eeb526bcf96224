"""Request floods against a replicated quorum-read service.

The training-side netsim replays the scatter/gather schedule; this module
models the *serving* side (``repro_torch.serve``): ``n_clients`` independent
clients fire Poisson request streams at R replicas, every request fans out
to all replicas (a quorum read), each replica serves its own FIFO queue,
and the client's read completes at the (R-f)-th reply — replies landing
after the quorum closed are *late* (counted, not consumed), exactly the
ledger convention of the training simulator.

The hot path is vectorized end-to-end: one Poisson draw for all arrival
counts, one latency draw per (request, replica) matrix, and a per-replica
Lindley recursion computed with ``np.maximum.accumulate`` (no Python loop
over requests) — floods of 10^5+ requests take well under a second.

Accounting lands in the standard :class:`~repro_torch.netsim.accounting
.MessageLedger` with nodes ``0..R-1`` the replicas ("servers") and
``R..R+n_clients-1`` the clients: ``push`` = requests up, ``pull`` =
replies down.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .accounting import MessageLedger
from .events import EventLoop
from .latency import (ComputeTime, FixedLatency, LatencyModel,
                      LognormalLatency, ParetoLatency)


@dataclass(frozen=True)
class RequestFloodScenario:
    """Shape + load + timing of one flood (deliberately *not* a training
    :class:`~repro_torch.netsim.scenarios.Scenario` — serving has no Table-1
    worker/server preconditions, only the read quorum n >= 2f+1)."""
    name: str = "request_flood"
    n_clients: int = 1000
    rate: float = 2.0                 # requests/sec per client
    duration_ms: float = 1000.0
    n_replicas: int = 4
    f: int = 1
    req_bytes: int = 256              # prompt ids
    reply_bytes: int = 2048           # logits / tokens back
    latency: LatencyModel = field(default_factory=LognormalLatency)
    # default keeps the fleet stable (~70% utilization at 1000 x 2/s: every
    # request hits every replica, so per-replica load = total rate x service)
    service: ComputeTime = field(default_factory=lambda: ComputeTime(0.35, 0.2))
    slow_replicas: tuple[int, ...] = ()   # degraded replicas...
    slow_factor: float = 1.0              # ...serve this much slower
    deadline_ms: float | None = None
    seed: int = 0

    def __post_init__(self):
        if self.n_replicas < 2 * self.f + 1:
            raise ValueError(f"quorum reads need n >= 2f+1 replicas "
                             f"(got n={self.n_replicas}, f={self.f})")
        if any(not 0 <= i < self.n_replicas for i in self.slow_replicas):
            raise ValueError(f"slow_replicas out of range: "
                             f"{self.slow_replicas}")


def _sample_many(model: LatencyModel, rng: np.random.Generator,
                 n: int) -> np.ndarray:
    """Vectorized n-sample for the link-independent latency models; generic
    models fall back to a per-message loop (same distributions either way)."""
    if isinstance(model, FixedLatency):
        return np.full(n, model.ms)
    if isinstance(model, LognormalLatency):
        return model.median_ms * np.exp(model.sigma * rng.standard_normal(n))
    if isinstance(model, ParetoLatency):
        return model.floor_ms * (1.0 + rng.pareto(model.alpha, n))
    return np.array([model.sample(rng, 0, 1) for _ in range(n)])


def _service_many(model: ComputeTime, rng: np.random.Generator,
                  n: int) -> np.ndarray:
    return model.mean_ms * np.exp(model.sigma * rng.standard_normal(n)
                                  - 0.5 * model.sigma ** 2)


def _lindley(arrive: np.ndarray, svc: np.ndarray
             ) -> tuple[np.ndarray, np.ndarray]:
    """FIFO single-server queue: finish[i] = max(arrive[i], finish[i-1]) +
    svc[i], vectorized as C[i] + max_{j<=i}(arrive[j] - C[j-1]) with C the
    service-time cumsum. Returns (start, finish) in arrival order."""
    C = np.cumsum(svc)
    start = np.maximum.accumulate(arrive - (C - svc))
    return start + (C - svc), start + C


@dataclass
class FloodTrace:
    """Result of one flood: per-request quorum latencies + the ledger."""
    scenario: RequestFloodScenario
    n_requests: int
    quorum_ms: np.ndarray             # [n_req] client-side read latency
    replica_busy_ms: np.ndarray       # [R] total service time per replica
    replica_served: np.ndarray        # [R] requests served per replica
    replica_late: np.ndarray          # [R] replies past the quorum close
    max_queue_ms: np.ndarray          # [R] worst queueing delay per replica
    deadline_missed: int
    ledger: MessageLedger
    wall_ms: float

    def percentiles(self, qs=(50, 95, 99)) -> dict:
        if self.n_requests == 0:
            return {f"p{q}": 0.0 for q in qs}
        return {f"p{q}": float(np.percentile(self.quorum_ms, q)) for q in qs}

    def summary(self) -> str:
        sc = self.scenario
        pc = self.percentiles()
        util = self.replica_busy_ms / max(self.wall_ms, 1e-9)
        lines = [
            f"[flood] {sc.name}: {sc.n_clients} clients x {sc.rate}/s over "
            f"{sc.duration_ms:.0f}ms -> {self.n_requests} requests, "
            f"R={sc.n_replicas} f={sc.f}",
            f"  quorum latency ms: p50 {pc['p50']:.2f}  p95 {pc['p95']:.2f}  "
            f"p99 {pc['p99']:.2f}"
            + (f"  deadline>{sc.deadline_ms:.0f}ms missed: "
               f"{self.deadline_missed}" if sc.deadline_ms else ""),
        ]
        for r in range(sc.n_replicas):
            tag = " (slow)" if r in sc.slow_replicas else ""
            lines.append(
                f"  replica {r}{tag}: served {int(self.replica_served[r]):6d}"
                f"  busy {self.replica_busy_ms[r]:9.1f}ms"
                f" (util {util[r]:5.1%})"
                f"  late {int(self.replica_late[r]):6d}"
                f"  max queue {self.max_queue_ms[r]:8.2f}ms")
        lines.append("  " + self.ledger.summary().replace("\n", "\n  "))
        return "\n".join(lines)


def run_flood(sc: RequestFloodScenario) -> FloodTrace:
    """Simulate one flood (see module docstring for the model)."""
    loop = EventLoop(sc.seed)     # deterministic (seed, label) streams
    R, nC = sc.n_replicas, sc.n_clients
    ledger = MessageLedger(R + nC, n_servers=R)

    # -- arrivals: one Poisson draw across all clients ---------------------
    rng_arr = loop.stream("flood/arrivals")
    lam = sc.rate * sc.duration_ms / 1e3
    counts = rng_arr.poisson(lam, nC)                      # [nC]
    n_req = int(counts.sum())
    client = np.repeat(np.arange(nC), counts)              # [n_req]
    t_arr = rng_arr.uniform(0.0, sc.duration_ms, n_req)
    order = np.argsort(t_arr, kind="stable")
    client, t_arr = client[order], t_arr[order]

    if n_req == 0:
        return FloodTrace(sc, 0, np.zeros(0), np.zeros(R), np.zeros(R),
                          np.zeros(R), np.zeros(R), 0, ledger, 0.0)

    # -- fan-out: every request hits every replica -------------------------
    rng_net = loop.stream("flood/links")
    up = _sample_many(sc.latency, rng_net, n_req * R).reshape(n_req, R)
    t_at_replica = t_arr[:, None] + up                     # [n_req, R]
    np.add.at(ledger.c["push"]["tx_msgs"], R + client, R)
    np.add.at(ledger.c["push"]["tx_bytes"], R + client, R * sc.req_bytes)
    ledger.c["push"]["rx_msgs"][:R] += n_req
    ledger.c["push"]["rx_bytes"][:R] += n_req * sc.req_bytes

    # -- per-replica FIFO queues (Lindley, vectorized) ---------------------
    rng_svc = loop.stream("flood/service")
    t_reply = np.empty((n_req, R))
    busy = np.zeros(R)
    served = np.zeros(R, np.int64)
    max_q = np.zeros(R)
    for r in range(R):
        svc = _service_many(sc.service, rng_svc, n_req)
        if r in sc.slow_replicas:
            svc = svc * sc.slow_factor
        idx = np.argsort(t_at_replica[:, r], kind="stable")
        start, finish = _lindley(t_at_replica[idx, r], svc[idx])
        max_q[r] = float(np.max(start - t_at_replica[idx, r]))
        down = _sample_many(sc.latency, rng_net, n_req)
        t_reply[idx, r] = finish + down
        busy[r] = float(svc.sum())
        served[r] = n_req

    # -- quorum close: the (R-f)-th reply completes the read ---------------
    need = R - sc.f
    t_quorum = np.partition(t_reply, need - 1, axis=1)[:, need - 1]
    quorum_ms = t_quorum - t_arr
    late = t_reply > t_quorum[:, None]                     # [n_req, R]

    ledger.c["pull"]["tx_msgs"][:R] += n_req
    ledger.c["pull"]["tx_bytes"][:R] += n_req * sc.reply_bytes
    on_time = ~late
    np.add.at(ledger.c["pull"]["rx_msgs"], R + client, on_time.sum(1))
    np.add.at(ledger.c["pull"]["rx_bytes"], R + client,
              on_time.sum(1) * sc.reply_bytes)
    np.add.at(ledger.c["pull"]["late_msgs"], R + client, late.sum(1))
    np.add.at(ledger.c["pull"]["late_bytes"], R + client,
              late.sum(1) * sc.reply_bytes)

    missed = int((quorum_ms > sc.deadline_ms).sum()) if sc.deadline_ms else 0
    wall = float(t_reply.max())
    return FloodTrace(sc, n_req, quorum_ms, busy, served,
                      late.sum(0).astype(np.int64), max_q, missed, ledger,
                      wall)

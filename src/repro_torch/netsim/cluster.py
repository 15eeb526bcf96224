"""Event-driven ByzSGD cluster: servers/workers exchanging the paper's
scatter/gather schedule over a simulated network.

Node processes (state machines driven by the event loop):

  * server s entering scatter step k broadcasts its model (tagged k) to every
    worker, then waits for q_w gradients tagged k, applies the GAR update
    (``update_ms``), and — every T steps — runs a DMC gather round with the
    other servers (q_ps models including its own) before entering k+1;
  * worker w at step k waits for q_ps models tagged k, aggregates, computes a
    gradient (``compute`` time model), pushes it (tagged k) to every server
    and enters k+1.

Messages carry their send time; realized per-step quorums are the first q
distinct senders in *arrival order* and per-message staleness is
arrival - send (virtual ms). There are no retransmits: losses, partitions and
crashes surface as late quorums or — when a quorum can never fill — as
*forced* closes (padded with already-delivered senders, counted in
``trace.shortfalls``) so the emitted trace is always complete and can drive
the protocol simulator.

Node ids: servers are 0..n_ps-1, workers n_ps..n_ps+n_w-1 (the ledger's
convention).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .accounting import MessageLedger
from .events import EventLoop
from .latency import transfer_ms


@dataclass
class NetsimTrace:
    """Realized delivery schedule + staleness + accounting of one run."""
    scenario: "Scenario"  # noqa: F821 - netsim.scenarios.Scenario
    pull_idx: np.ndarray     # [steps, n_w, q_ps] int32, server ids
    pull_stale: np.ndarray   # [steps, n_w, q_ps] float32 ms
    push_idx: np.ndarray     # [steps, n_ps, q_w] int32, worker ids (0-based)
    push_stale: np.ndarray   # [steps, n_ps, q_w] float32 ms
    gather_idx: np.ndarray   # [n_gathers, n_ps, q_ps] int32, server ids
    gather_stale: np.ndarray  # [n_gathers, n_ps, q_ps] float32 ms
    step_done_ms: np.ndarray  # [steps] last server update completion time
    ledger: MessageLedger
    shortfalls: int = 0      # quorum slots force-filled (faults starved them)
    events: int = 0

    @property
    def n_gathers(self) -> int:
        return self.gather_idx.shape[0]

    def to_delivery(self, device=None):
        """Package as a :class:`repro_torch.core.quorum.TraceDelivery` whose
        index tables are staged on ``device`` (the GPU unless ``"cpu"``)."""
        from ..core.quorum import TraceDelivery
        return TraceDelivery(self.pull_idx, self.push_idx, self.gather_idx,
                             T=self.scenario.T, pull_stale=self.pull_stale,
                             push_stale=self.push_stale,
                             gather_stale=self.gather_stale, device=device)

    # -- realized quorums as delivery masks --------------------------------
    # The masked-aggregation form of the trace: [steps, n_recv, n_send] bool,
    # consumable by any mask-capable rule in the agg registry
    # (``agg.get(name)(x, f, mask=pull_masks()[k, w])``), not just the Median.
    @staticmethod
    def _to_masks(idx: np.ndarray, n_send: int) -> np.ndarray:
        steps, n_recv, q = idx.shape
        m = np.zeros((steps, n_recv, n_send), bool)
        s = np.repeat(np.arange(steps), n_recv * q)
        r = np.tile(np.repeat(np.arange(n_recv), q), steps)
        m[s, r, idx.ravel()] = True
        return m

    def pull_masks(self) -> np.ndarray:
        """[steps, n_w, n_ps] delivered-server masks per worker."""
        return self._to_masks(self.pull_idx, self.scenario.n_servers)

    def push_masks(self) -> np.ndarray:
        """[steps, n_ps, n_w] delivered-worker masks per server."""
        return self._to_masks(self.push_idx, self.scenario.n_workers)

    def gather_masks(self) -> np.ndarray:
        """[n_gathers, n_ps, n_ps] delivered-server masks per server."""
        return self._to_masks(self.gather_idx, self.scenario.n_servers)


class _Quorum:
    """Arrival buffer for one (receiver, tag): first q distinct senders."""
    __slots__ = ("senders", "stale", "closed")

    def __init__(self):
        self.senders: list[int] = []
        self.stale: list[float] = []
        self.closed = False

    def seen(self, src: int) -> bool:
        return src in self.senders

    def add(self, src: int, staleness: float) -> None:
        self.senders.append(src)
        self.stale.append(staleness)


class ClusterSim:
    def __init__(self, scenario):
        self.sc = scenario
        self.loop = EventLoop(scenario.seed)
        self.lat_rng = self.loop.stream("latency")
        self.fault_rng = self.loop.stream("faults")
        self.comp_rng = self.loop.stream("compute")
        sc = scenario
        self.n_ps, self.n_w = sc.n_servers, sc.n_workers
        self.nbytes = sc.model_d * sc.dtype_bytes
        self.n_gathers = sc.steps // sc.T
        self.ledger = MessageLedger(self.n_ps + self.n_w, self.n_ps)
        # node progress
        self.s_step = [0] * self.n_ps      # server's current scatter step
        self.w_step = [0] * self.n_w
        self.s_done = [False] * self.n_ps
        self.w_done = [False] * self.n_w
        # open quorums: bufs[receiver][(phase, tag)] -> _Quorum
        self.s_push: list[dict[int, _Quorum]] = [dict() for _ in range(self.n_ps)]
        self.s_gather: list[dict[int, _Quorum]] = [dict() for _ in range(self.n_ps)]
        self.w_pull: list[dict[int, _Quorum]] = [dict() for _ in range(self.n_w)]
        self.shortfalls = 0
        self._gather_next_k: dict[tuple[int, int], int] = {}
        # trace arrays
        S, G = sc.steps, self.n_gathers
        self.pull_idx = np.zeros((S, self.n_w, sc.pull_need), np.int32)
        self.pull_stale = np.zeros((S, self.n_w, sc.pull_need), np.float32)
        self.push_idx = np.zeros((S, self.n_ps, sc.push_need), np.int32)
        self.push_stale = np.zeros((S, self.n_ps, sc.push_need), np.float32)
        self.gather_idx = np.zeros((G, self.n_ps, sc.q_servers), np.int32)
        self.gather_stale = np.zeros((G, self.n_ps, sc.q_servers), np.float32)
        self.step_done_ms = np.zeros(S, np.float64)
        # closed-row flags: a legitimately closed quorum can record the
        # all-zeros row (e.g. sync pull_need=1 delivering server 0), so the
        # dead-row fill must not infer "never closed" from the values
        self.pull_closed = np.zeros((S, self.n_w), bool)
        self.push_closed = np.zeros((S, self.n_ps), bool)

    def _pull_fallback(self, w: int, k: int):
        """Pad pattern for a starved pull quorum: in the sync schedule the
        only scheduled sender is the round-robin server (w + k) % n_ps."""
        if self.sc.variant == "sync":
            return lambda i: (w + k + i) % self.n_ps
        return lambda i: (w + i) % self.n_ps

    def _push_fallback(self, s: int, k: int):
        """Pad pattern for a starved push quorum: in the sync schedule the
        scheduled senders are the workers w ≡ (s - k) (mod n_ps) — the
        round-robin exchange partners of server s at step k. Pads cycle
        WITHIN that class so a forced close never attributes a gradient to a
        worker the schedule would not route here."""
        if self.sc.variant == "sync":
            r = (s - k) % self.n_ps
            cnt = self.sc.push_scheduled(s, k)
            if cnt == 0:  # degenerate (n_ps > n_w residue): nothing scheduled
                return lambda i: (r + i) % self.n_w
            return lambda i: r + (i % cnt) * self.n_ps
        return lambda i: (s + i) % self.n_w

    # -- wire --------------------------------------------------------------
    def _send(self, src: int, dst: int, phase: str, tag: int) -> None:
        t = self.loop.now
        self.ledger.send(src, phase, self.nbytes)
        f = self.sc.faults
        if f.blocked(src, dst, t) or f.lossy.drops(self.fault_rng):
            self.ledger.drop(dst, phase)
            return
        delay = (self.sc.latency.sample(self.lat_rng, src, dst)
                 * f.latency_scale(src, dst, t)
                 + transfer_ms(self.nbytes, self.sc.bandwidth_gbps))
        self.loop.after(delay, self._deliver, src, dst, phase, tag, t, False)
        if f.lossy.duplicates(self.fault_rng):
            self.loop.after(delay + f.lossy.dup_extra_ms, self._deliver,
                            src, dst, phase, tag, t, True)

    def _deliver(self, src, dst, phase, tag, send_t, is_dup) -> None:
        t = self.loop.now
        if not self.sc.faults.is_up(dst, t):
            self.ledger.drop(dst, phase)
            return
        if is_dup:
            self.ledger.dup(dst, phase)
        stale = t - send_t
        if phase == "pull":
            self._worker_on_model(dst - self.n_ps, tag, src, stale)
        elif phase == "push":
            self._server_on_grad(dst, tag, src - self.n_ps, stale)
        else:
            self._server_on_gather(dst, tag, src, stale)

    # -- worker process ----------------------------------------------------
    def _worker_enter_step(self, w: int, k: int) -> None:
        if k >= self.sc.steps:
            self.w_done[w] = True
            return
        self.w_step[w] = k
        self._worker_try_close(w)

    def _worker_on_model(self, w: int, tag: int, server: int,
                         stale: float) -> None:
        if self.w_done[w] or tag < self.w_step[w]:
            self.ledger.late(self.n_ps + w, "pull", self.nbytes)
            return
        q = self.w_pull[w].setdefault(tag, _Quorum())
        if q.closed or q.seen(server):
            self.ledger.late(self.n_ps + w, "pull", self.nbytes)
            return
        q.add(server, stale)
        if tag == self.w_step[w]:
            self._worker_try_close(w)

    def _worker_try_close(self, w: int, force: bool = False) -> None:
        k = self.w_step[w]
        q = self.w_pull[w].setdefault(k, _Quorum())
        need = self.sc.pull_need
        if q.closed or (len(q.senders) < need and not force):
            return
        q.closed = True
        # sync pads must name the round-robin server that was actually
        # scheduled to send at step k, or the trace/ledger would attribute
        # the pull to a server that never sent it
        fb = self._pull_fallback(w, k)
        idx, stale = _pad(q.senders, q.stale, need, fallback=fb)
        self.shortfalls += max(need - len(q.senders), 0)
        self.pull_idx[k, w] = idx
        self.pull_stale[k, w] = stale
        self.pull_closed[k, w] = True
        for _ in range(min(len(q.senders), need)):
            self.ledger.deliver(self.n_ps + w, "pull", self.nbytes)
        for _ in range(max(len(q.senders) - need, 0)):
            self.ledger.late(self.n_ps + w, "pull", self.nbytes)
        dt = self.sc.compute.sample(self.comp_rng)
        self.loop.after(dt, self._worker_compute_done, w, k)

    def _worker_compute_done(self, w: int, k: int) -> None:
        t = self.loop.now
        if not self.sc.faults.is_up(self.n_ps + w, t):
            up = self.sc.faults.next_up(self.n_ps + w, t)
            if up != float("inf"):
                self.loop.at(up, self._worker_compute_done, w, k)
            return
        for s in range(self.n_ps):
            # sync (§5): the gradient goes ONLY to the round-robin server the
            # worker exchanges with this step — the request half of the
            # server-side round-robin reply pair, not a broadcast (the
            # worker_tx n_ps·d -> 1·d byte-model correction; see
            # exp_messages.model_bytes). Async broadcasts to every server.
            if self.sc.variant == "sync" and (w + k) % self.n_ps != s:
                continue
            self._send(self.n_ps + w, s, "push", k)
        self._worker_enter_step(w, k + 1)

    # -- server process ----------------------------------------------------
    def _server_enter_step(self, s: int, k: int) -> None:
        t = self.loop.now
        if not self.sc.faults.is_up(s, t):
            up = self.sc.faults.next_up(s, t)
            if up != float("inf"):
                self.loop.at(up, self._server_enter_step, s, k)
            return
        if k >= self.sc.steps:
            self.s_done[s] = True
            return
        self.s_step[s] = k
        for w in range(self.n_w):
            # sync variant (§5): worker w pulls ONE model per step, from the
            # round-robin server (w + k) % n_ps — the byte saving the paper's
            # throughput argument rests on. Async broadcasts to everyone.
            if self.sc.variant == "sync" and (w + k) % self.n_ps != s:
                continue
            self._send(s, self.n_ps + w, "pull", k)
        self._server_try_close(s)

    def _server_on_grad(self, s: int, tag: int, worker: int,
                        stale: float) -> None:
        if self.s_done[s] or tag < self.s_step[s]:
            self.ledger.late(s, "push", self.nbytes)
            return
        q = self.s_push[s].setdefault(tag, _Quorum())
        if q.closed or q.seen(worker):
            self.ledger.late(s, "push", self.nbytes)
            return
        q.add(worker, stale)
        if tag == self.s_step[s]:
            self._server_try_close(s)

    def _server_try_close(self, s: int, force: bool = False) -> None:
        k = self.s_step[s]
        q = self.s_push[s].setdefault(k, _Quorum())
        # the wait threshold is the SCHEDULED sender count (sync: only the
        # round-robin exchange partners; async: the q_w quorum); the trace row
        # width stays the rectangular push_need, padded by cycling — width
        # padding is schedule geometry, never counted as a shortfall
        need = self.sc.push_scheduled(s, k)
        width = self.sc.push_need
        if q.closed or (len(q.senders) < need and not force):
            return
        q.closed = True
        idx, stale = _pad(q.senders, q.stale, width,
                          fallback=self._push_fallback(s, k))
        self.shortfalls += max(need - len(q.senders), 0)
        self.push_idx[k, s] = idx
        self.push_stale[k, s] = stale
        self.push_closed[k, s] = True
        for _ in range(min(len(q.senders), width)):
            self.ledger.deliver(s, "push", self.nbytes)
        for _ in range(max(len(q.senders) - width, 0)):
            self.ledger.late(s, "push", self.nbytes)
        self.loop.after(self.sc.update_ms, self._server_update_done, s, k)

    def _server_update_done(self, s: int, k: int) -> None:
        t = self.loop.now
        if not self.sc.faults.is_up(s, t):
            up = self.sc.faults.next_up(s, t)
            if up != float("inf"):
                self.loop.at(up, self._server_update_done, s, k)
            return
        self.step_done_ms[k] = max(self.step_done_ms[k], t)
        if (k + 1) % self.sc.T == 0 and (k + 1) // self.sc.T <= self.n_gathers:
            self._server_enter_gather(s, (k + 1) // self.sc.T - 1, k + 1)
        else:
            self._server_enter_step(s, k + 1)

    # -- DMC gather round --------------------------------------------------
    def _server_enter_gather(self, s: int, r: int, next_k: int) -> None:
        q = self.s_gather[s].setdefault(r, _Quorum())
        # Own model goes FIRST regardless of remote models already buffered
        # for this round (they waited for the receiver to enter it): a server
        # always aggregates its own parameter vector (Algorithm 2).
        q.senders.insert(0, s)
        q.stale.insert(0, 0.0)
        self.ledger.deliver(s, "gather", self.nbytes)
        for o in range(self.n_ps):
            if o != s:
                self._send(s, o, "gather", r)
        self._gather_next_k[(s, r)] = next_k
        self._server_try_gather_close(s, r)

    def _server_on_gather(self, s: int, r: int, src: int,
                          stale: float) -> None:
        q = self.s_gather[s].setdefault(r, _Quorum())
        if q.closed or q.seen(src):
            self.ledger.late(s, "gather", self.nbytes)
            return
        q.add(src, stale)
        self._server_try_gather_close(s, r)

    def _server_try_gather_close(self, s: int, r: int,
                                 force: bool = False) -> None:
        q = self.s_gather[s].setdefault(r, _Quorum())
        need = self.sc.q_servers
        if q.closed or (s, r) not in self._gather_next_k \
                or (len(q.senders) < need and not force):
            return
        q.closed = True
        idx, stale = _pad(q.senders, q.stale, need,
                          fallback=lambda i: (s + i) % self.n_ps)
        self.shortfalls += max(need - len(q.senders), 0)
        self.gather_idx[r, s] = idx
        self.gather_stale[r, s] = stale
        for _ in range(min(len(q.senders), need) - 1):  # self counted at entry
            self.ledger.deliver(s, "gather", self.nbytes)
        for _ in range(max(len(q.senders) - need, 0)):
            self.ledger.late(s, "gather", self.nbytes)
        next_k = self._gather_next_k.pop((s, r))
        self.loop.after(self.sc.update_ms, self._server_enter_step, s, next_k)

    # -- run ---------------------------------------------------------------
    def _alive(self, node: int) -> bool:
        """Node can still make progress (not crashed forever)."""
        t = self.loop.now
        return self.sc.faults.is_up(node, t) or \
            self.sc.faults.next_up(node, t) != float("inf")

    def run(self) -> NetsimTrace:
        for s in range(self.n_ps):
            self.loop.at(0.0, self._server_enter_step, s, 0)
        for w in range(self.n_w):
            self.loop.at(0.0, self._worker_enter_step, w, 0)
        guard = 4 * (self.n_ps + self.n_w) * max(self.sc.steps, 1)
        for _ in range(guard):
            self.loop.run(max_events=self.sc.max_events)
            stuck_s = [s for s in range(self.n_ps)
                       if not self.s_done[s] and self._alive(s)]
            stuck_w = [w for w in range(self.n_w)
                       if not self.w_done[w] and self._alive(self.n_ps + w)]
            if not stuck_s and not stuck_w:
                break
            # heap drained with live nodes blocked: faults starved a quorum.
            # Force-close the open quorums so the schedule stays complete.
            for w in stuck_w:
                self._worker_try_close(w, force=True)
            for s in stuck_s:
                r = next((r for (s2, r) in self._gather_next_k
                          if s2 == s), None)
                if r is not None:
                    self._server_try_gather_close(s, r, force=True)
                else:
                    self._server_try_close(s, force=True)
        self._fill_dead_rows()
        return NetsimTrace(self.sc, self.pull_idx, self.pull_stale,
                           self.push_idx, self.push_stale, self.gather_idx,
                           self.gather_stale, self.step_done_ms, self.ledger,
                           self.shortfalls, self.loop.processed)

    def _fill_dead_rows(self) -> None:
        """Rows owned by permanently-dead nodes never closed; fill them with
        deterministic pads so the trace always drives the simulator."""
        for k in range(self.sc.steps):
            for w in range(self.n_w):
                if not self.pull_closed[k, w] and self.w_step[w] <= k \
                        and not self.w_done[w]:
                    fb = self._pull_fallback(w, k)
                    self.pull_idx[k, w] = [fb(i)
                                           for i in range(self.sc.pull_need)]
                    self.shortfalls += self.sc.pull_need
            for s in range(self.n_ps):
                if not self.push_closed[k, s] and self.s_step[s] <= k \
                        and not self.s_done[s]:
                    fb = self._push_fallback(s, k)
                    self.push_idx[k, s] = [fb(i)
                                           for i in range(self.sc.push_need)]
                    self.shortfalls += self.sc.push_scheduled(s, k)
        for r in range(self.n_gathers):
            for s in range(self.n_ps):
                if not self.gather_idx[r, s].any():
                    self.gather_idx[r, s] = [(s + i) % self.n_ps
                                             for i in range(self.sc.q_servers)]


def _pad(senders: list[int], stale: list[float], need: int, fallback):
    """First ``need`` senders in arrival order; cycle delivered senders (or a
    deterministic fallback pattern when nothing arrived) to fill shortfall."""
    idx = list(senders[:need])
    st = list(stale[:need])
    i = 0
    while len(idx) < need:
        if senders:
            idx.append(senders[i % len(senders)])
            st.append(stale[i % len(stale)])
        else:
            idx.append(fallback(i))
            st.append(0.0)
        i += 1
    return np.asarray(idx, np.int32), np.asarray(st, np.float32)

"""Per-node message/byte/round accounting and analytic cross-validation.

Counting conventions (chosen to match the analytic :func:`model_bytes`):

  * ``tx`` is counted at send time, once per copy put on the wire;
  * ``rx`` counts only messages *consumed by a quorum* — arrivals after the
    receiver's quorum closed are ``late`` (the paper's model charges a
    receiver q-of-n deliveries, not n);
  * in the DMC gather a server's own model counts as one ``rx`` (the analytic
    model charges q_ps aggregated models including self);
  * ``dropped`` covers loss, partitions, and dead endpoints; ``dup`` counts
    extra copies delivered by duplication.
"""
from __future__ import annotations

import numpy as np

PHASES = ("pull", "push", "gather")
_COUNTERS = ("tx_msgs", "tx_bytes", "rx_msgs", "rx_bytes", "late_msgs",
             "late_bytes", "dropped_msgs", "dup_msgs")


class MessageLedger:
    """Counter matrix [phase][counter][node]; nodes 0..n_servers-1 are
    servers, the rest workers (the cluster engine's id convention)."""

    def __init__(self, n_nodes: int, n_servers: int):
        self.n_nodes = n_nodes
        self.n_servers = n_servers
        self.c = {p: {k: np.zeros(n_nodes, np.int64) for k in _COUNTERS}
                  for p in PHASES}

    # -- recording ---------------------------------------------------------
    def send(self, node, phase, nbytes, copies=1):
        self.c[phase]["tx_msgs"][node] += copies
        self.c[phase]["tx_bytes"][node] += nbytes * copies

    def deliver(self, node, phase, nbytes):
        self.c[phase]["rx_msgs"][node] += 1
        self.c[phase]["rx_bytes"][node] += nbytes

    def late(self, node, phase, nbytes):
        self.c[phase]["late_msgs"][node] += 1
        self.c[phase]["late_bytes"][node] += nbytes

    def drop(self, node, phase):
        self.c[phase]["dropped_msgs"][node] += 1

    def dup(self, node, phase):
        self.c[phase]["dup_msgs"][node] += 1

    # -- views -------------------------------------------------------------
    def _srv(self, phase, key):
        return int(self.c[phase][key][:self.n_servers].sum())

    def _wrk(self, phase, key):
        return int(self.c[phase][key][self.n_servers:].sum())

    def totals(self) -> dict:
        return {p: {k: int(v.sum()) for k, v in d.items()}
                for p, d in self.c.items()}

    def per_step_bytes(self, n_steps: int, n_gathers: int) -> dict:
        """Average per-node per-step byte rates in the analytic model's five
        categories. ``dmc_server_exchange`` is per server per *gather*."""
        n_w = self.n_nodes - self.n_servers
        n_ps = self.n_servers
        out = {
            "worker_rx": self._wrk("pull", "rx_bytes") / (n_w * n_steps),
            "worker_tx": self._wrk("push", "tx_bytes") / (n_w * n_steps),
            "server_rx": self._srv("push", "rx_bytes") / (n_ps * n_steps),
            "server_tx": self._srv("pull", "tx_bytes") / (n_ps * n_steps),
        }
        if n_gathers:
            out["dmc_server_exchange"] = (
                self._srv("gather", "tx_bytes")
                + self._srv("gather", "rx_bytes")) / (n_ps * n_gathers)
        return out

    def summary(self, scenario=None) -> str:
        head = f"[netsim ledger] {scenario.name}" if scenario is not None \
            else "[netsim ledger]"
        lines = [head]
        for p in PHASES:
            d = self.c[p]
            lines.append(
                f"  {p:6s}: tx {int(d['tx_msgs'].sum()):7d} msgs "
                f"({d['tx_bytes'].sum()/1e6:9.2f} MB)  "
                f"rx {int(d['rx_msgs'].sum()):7d}  "
                f"late {int(d['late_msgs'].sum()):6d}  "
                f"dropped {int(d['dropped_msgs'].sum()):5d}  "
                f"dup {int(d['dup_msgs'].sum()):4d}")
        return "\n".join(lines)

    def __eq__(self, other):
        return (isinstance(other, MessageLedger)
                and self.n_nodes == other.n_nodes
                and self.n_servers == other.n_servers
                and all(np.array_equal(self.c[p][k], other.c[p][k])
                        for p in PHASES for k in _COUNTERS))


def model_bytes(d: int, n_w: int, n_ps: int, f_w: int, f_ps: int, T: int,
                dtype_bytes: int = 4):
    """The analytic per-step communication model of the paper's schedules
    (bytes per node per step, q = n - f quorums): async scatter, sync §5
    round-robin, and the DMC exchange every T steps. The port's own copy of
    the function the JAX package keeps beside its message benchmark."""
    q_ps = n_ps - f_ps
    q_w = n_w - f_w
    D = d * dtype_bytes
    async_step = {
        "worker_rx": q_ps * D, "worker_tx": n_ps * D,
        "server_rx": q_w * D, "server_tx": n_w * D,
    }
    sync_step = {
        "worker_rx": 1 * D, "worker_tx": 1 * D,       # round-robin reply pair
        "server_rx": n_w * D / n_ps, "server_tx": n_w * D / n_ps,
    }
    dmc = {"server_exchange": (n_ps - 1) * D + q_ps * D}
    tot_async = sum(async_step.values()) + dmc["server_exchange"] / T
    tot_sync = sum(sync_step.values()) + dmc["server_exchange"] / T
    return {"async": async_step, "sync": sync_step, "dmc": dmc,
            "total_async": tot_async, "total_sync": tot_sync,
            "sync_gain": tot_async / tot_sync}


def compare_with_model(ledger: MessageLedger, scenario, n_steps: int,
                       n_gathers: int) -> dict:
    """Simulated per-step byte rates vs the analytic communication model of
    :func:`model_bytes`. Returns {category: (simulated, analytic,
    rel_err)}; on the uniform no-fault scenario every rel_err should be ~0."""
    m = model_bytes(scenario.model_d, scenario.n_workers, scenario.n_servers,
                    scenario.f_workers, scenario.f_servers, scenario.T,
                    dtype_bytes=scenario.dtype_bytes)
    D = scenario.model_d * scenario.dtype_bytes
    analytic = dict(m["async"],
                    dmc_server_exchange=m["dmc"]["server_exchange"])
    # model_bytes hardcodes q = n - f; when the scenario overrides a quorum
    # (e.g. q_servers = 2f+2 > n-f on small server counts), adjust the
    # q-dependent categories so the comparison stays apples-to-apples.
    if scenario.q_servers != scenario.n_servers - scenario.f_servers:
        analytic["worker_rx"] = scenario.q_servers * D
        analytic["dmc_server_exchange"] = \
            (scenario.n_servers - 1 + scenario.q_servers) * D
    if scenario.q_workers != scenario.n_workers - scenario.f_workers:
        analytic["server_rx"] = scenario.q_workers * D
    sim = ledger.per_step_bytes(n_steps, n_gathers)
    out = {}
    for k, s in sim.items():
        a = analytic[k]
        out[k] = (s, a, abs(s - a) / max(a, 1e-12))
    return out

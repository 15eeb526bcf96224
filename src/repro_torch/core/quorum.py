"""Delivery models (the asynchrony abstraction) of ``repro.core.quorum``.

Which q-of-n messages a receiver delivers each step (the paper's Assumption
7: every delivering configuration has probability >= rho > 0):

  * :class:`UniformDelivery` — uniform sampling over configurations from a
    ``torch.Generator`` (rho = 1/C(n, q));
  * :class:`TraceDelivery` — int index tables replayed step by step (a
    test's fixed quorums: the vehicle of every parity test against the JAX
    simulator; a realized netsim schedule, with its staleness, once netsim is
    ported).

``t`` is the host step counter (the port's simulator keeps it on the host).
"""
from __future__ import annotations

import numpy as np
import torch


def receiver_quorum_indices(gen: torch.Generator, n_recv: int, n_send: int,
                            q: int, include_self: bool = False,
                            device=None) -> torch.Tensor:
    """``[n_recv, q]`` delivered sender indices per receiver, uniform over
    q-subsets; ``include_self`` always delivers the receiver's own
    index."""
    scores = torch.rand((n_recv, n_send), generator=gen, device=device)
    if include_self:
        idx = torch.arange(n_recv, device=device)
        scores[idx, idx] = -1.0
    return torch.argsort(scores, dim=1, stable=True)[:, :q]


class UniformDelivery:
    """Assumption 7: uniform q-of-n quorum sampling from the simulator's
    generator."""

    def __init__(self, n_workers: int, n_servers: int, q_workers: int,
                 q_servers: int):
        self.n_workers, self.n_servers = n_workers, n_servers
        self.q_workers, self.q_servers = q_workers, q_servers

    @classmethod
    def from_config(cls, cfg) -> "UniformDelivery":
        return cls(cfg.n_workers, cfg.n_servers, cfg.q_workers, cfg.q_servers)

    def pull_indices(self, gen, t: int, device=None):
        del t
        return receiver_quorum_indices(gen, self.n_workers, self.n_servers,
                                       self.q_servers, device=device)

    def push_indices(self, gen, t: int, device=None):
        del t
        return receiver_quorum_indices(gen, self.n_servers, self.n_workers,
                                       self.q_workers, device=device)

    def gather_indices(self, gen, t: int, device=None):
        del t
        return receiver_quorum_indices(gen, self.n_servers, self.n_servers,
                                       self.q_servers, include_self=True,
                                       device=device)


class TraceDelivery:
    """Replay quorum index tables: ``pull [steps, n_w, q_ps]``,
    ``push [steps, n_ps, q_w]``, ``gather [n_gathers, n_ps, q_ps]``.

    Steps beyond the trace wrap around (t mod trace length). The gather table
    is indexed by round r = t/T - 1: the simulator enters the gather after
    the scatter step that brings the counter to a multiple of T. The tables
    are staged on ``device`` once.
    """

    def __init__(self, pull_idx, push_idx, gather_idx, T: int, device=None):
        def stage(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                   device=device)

        self.pull, self.push = stage(pull_idx), stage(push_idx)
        self.gather = stage(gather_idx)
        if self.gather.ndim != 3 or self.gather.shape[0] == 0:
            raise ValueError("gather trace must be [n_gathers>0, n_ps, q_ps]; "
                             "simulate at least T steps")
        self.T = int(T)
        self.steps = int(self.pull.shape[0])
        self.n_gathers = int(self.gather.shape[0])

    def pull_indices(self, gen, t: int, device=None):
        del gen, device
        return self.pull[t % self.steps]

    def push_indices(self, gen, t: int, device=None):
        del gen, device
        return self.push[t % self.steps]

    def gather_indices(self, gen, t: int, device=None):
        del gen, device
        r = t // self.T - 1
        return self.gather[r % self.n_gathers]


def validate_counts(n_w: int, f_w: int, n_ps: int, f_ps: int,
                    q_w: int, q_ps: int, synchronous: bool = False) -> None:
    """Paper's resilience preconditions (Table 1 + §5)."""
    if synchronous:
        if n_w < 2 * f_w + 1:
            raise ValueError(f"sync ByzSGD needs n_w >= 2f_w+1 ({n_w} < {2*f_w+1})")
    else:
        if n_w < 3 * f_w + 1:
            raise ValueError(f"async ByzSGD needs n_w >= 3f_w+1 ({n_w} < {3*f_w+1})")
    if n_ps < 3 * f_ps + 2:
        raise ValueError(f"ByzSGD needs n_ps >= 3f_ps+2 ({n_ps} < {3*f_ps+2})")
    if not (2 * f_w + 1 <= q_w <= n_w - f_w):
        raise ValueError(f"need 2f_w+1 <= q_w <= n_w-f_w, got q_w={q_w}")
    if not (2 * f_ps + 2 <= q_ps <= n_ps - f_ps):
        raise ValueError(f"need 2f_ps+2 <= q_ps <= n_ps-f_ps, got q_ps={q_ps}")

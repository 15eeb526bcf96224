"""Delivery models (the asynchrony abstraction) of ``repro.core.quorum``.

Which q-of-n messages a receiver delivers each step (the paper's Assumption
7: every delivering configuration has probability >= rho > 0):

  * :class:`UniformDelivery` — uniform sampling over configurations from a
    ``torch.Generator`` (rho = 1/C(n, q));
  * :class:`TraceDelivery` — int index tables replayed step by step: a
    realized :mod:`repro_torch.netsim` schedule with its staleness (latency
    tails, stragglers, crashes, partitions; a quorum that faults starved
    repeats a sender), or a test's fixed quorums.

``t`` is the host step counter (the port's simulator keeps it on the host).
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np
import torch

from ..device import resolve


def _scores(gen: torch.Generator, n: int, include: int | None, device):
    scores = torch.rand((n,), generator=gen, device=device)
    if include is not None:
        scores[include] = -1.0        # always delivered (own state)
    return scores


def sample_quorum_mask(gen: torch.Generator, n: int, q: int,
                       include: int | None = None,
                       device=None) -> torch.Tensor:
    """Bool ``[n]`` mask with exactly q True entries, uniform over
    configurations (Assumption 7 with rho = 1/C(n, q)), optionally forcing
    ``include``. The draws are the generator's, not JAX's threefry."""
    scores = _scores(gen, n, include, device)
    mask = torch.zeros(n, dtype=torch.bool, device=scores.device)
    return mask.scatter_(0, torch.argsort(scores, stable=True)[:q], True)


def receiver_quorum_masks(gen: torch.Generator, n_recv: int, n_send: int,
                          q: int, include_self: bool = False,
                          device=None) -> torch.Tensor:
    """``[n_recv, n_send]`` bool; row r has exactly q True.
    ``include_self`` forces the diagonal (a server always delivers its own
    parameter vector)."""
    idx = receiver_quorum_indices(gen, n_recv, n_send, q, include_self,
                                  device)
    masks = torch.zeros((n_recv, n_send), dtype=torch.bool,
                        device=idx.device)
    return masks.scatter_(1, idx, True)


def sample_quorum_indices(gen: torch.Generator, n: int, q: int,
                          include: int | None = None,
                          device=None) -> torch.Tensor:
    """Int ``[q]`` delivered indices (a uniform subset), optionally forcing
    ``include``."""
    return torch.argsort(_scores(gen, n, include, device), stable=True)[:q]


def full_quorum(n_recv: int, n_send: int, device=None) -> torch.Tensor:
    """Synchronous full delivery (no asynchrony)."""
    return torch.ones((n_recv, n_send), dtype=torch.bool, device=device)


@runtime_checkable
class DeliveryModel(Protocol):
    """What the simulator and the protocol need from an asynchrony model:
    per-step delivered sender indices for the three communication
    patterns (``t`` the host step counter)."""

    def pull_indices(self, gen, t: int, device=None) -> torch.Tensor:
        """``[n_workers, q_servers]`` server ids each worker delivers."""
        ...

    def push_indices(self, gen, t: int, device=None) -> torch.Tensor:
        """``[n_servers, q_workers]`` worker ids each server delivers."""
        ...

    def gather_indices(self, gen, t: int, device=None) -> torch.Tensor:
        """``[n_servers, q_servers]`` server ids (incl. self) for the DMC
        gather entered when the counter reaches ``t``."""
        ...

    def staleness(self, t: int) -> dict | None:
        """Mean per-message delivery staleness at step t (virtual ms), or
        ``None`` where the model has no notion of time."""
        ...


def receiver_quorum_indices(gen: torch.Generator, n_recv: int, n_send: int,
                            q: int, include_self: bool = False,
                            device=None) -> torch.Tensor:
    """``[n_recv, q]`` delivered sender indices per receiver, uniform over
    q-subsets; ``include_self`` always delivers the receiver's own
    index."""
    scores = torch.rand((n_recv, n_send), generator=gen, device=device)
    if include_self:
        # a fill, not an indexed store of a host scalar: no copy to the
        # device, so no sync with the host
        scores.diagonal().fill_(-1.0)
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

    def staleness(self, t: int):
        """Uniform sampling has no notion of time."""
        del t
        return None


class TraceDelivery:
    """Replay quorum index tables: ``pull [steps, n_w, q_ps]``,
    ``push [steps, n_ps, q_w]``, ``gather [n_gathers, n_ps, q_ps]``.

    Steps beyond the trace wrap around (t mod trace length). The gather table
    is indexed by round r = t/T - 1: the simulator enters the gather after
    the scatter step that brings the counter to a multiple of T. The tables
    are staged on ``device`` once (the GPU unless ``"cpu"`` is asked); the
    per-step mean staleness of the ``*_stale`` tables (virtual ms) is kept
    on the host, so :meth:`staleness` does no device work.
    """

    def __init__(self, pull_idx, push_idx, gather_idx, T: int,
                 pull_stale=None, push_stale=None, gather_stale=None,
                 device=None):
        device = resolve(device)

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

        def mean_per_step(a):
            if a is None:
                return None
            a = np.asarray(a, np.float32)
            return a.reshape(a.shape[0], -1).mean(axis=1)

        self._pull_stale_ms = mean_per_step(pull_stale)
        self._push_stale_ms = mean_per_step(push_stale)
        self._gather_stale_ms = mean_per_step(gather_stale)

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

    def staleness(self, t: int):
        """Mean delivery staleness (virtual ms) of the 0-based scatter step
        ``t`` just run, with the gather's on the step that ends a round;
        None without staleness tables."""
        if self._pull_stale_ms is None:
            return None
        k = int(t) % self.steps
        out = {"staleness_pull_ms": float(self._pull_stale_ms[k]),
               "staleness_push_ms": float(self._push_stale_ms[k])}
        if (int(t) + 1) % self.T == 0 and self._gather_stale_ms is not None:
            r = ((int(t) + 1) // self.T - 1) % self.n_gathers
            out["staleness_gather_ms"] = float(self._gather_stale_ms[r])
        return out


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

"""The fused runner — the port of ``repro.core.engine.EpochEngine``.

It steps the simulator L steps at a time (an epoch) with the gather
boundary of the JAX engine driven by the carried step counter, so any epoch
length — the tail of a run included — is correct:

* the async variant gathers after the step that brings the counter to a
  multiple of T (the stepwise loop's ``(i + 1) % T == 0``);
* the sync variant gathers *before* the step when ``t % T == 0 and t > 0``.

Batches arrive as one device tensor per epoch (``DeviceBatchStream.next``),
per-step metrics go into device buffers — ``acc`` only on the logged stride,
0 elsewhere, as ``engine.py:66-75`` — and the host sees ONE transfer per
``run``. The steps are exactly the stepwise loop's, so fused == stepwise.

Not ported: ``repro.core.epochs``' compile cache, which keys compiled
``lax.scan`` epochs — eager PyTorch compiles nothing per epoch. Capturing
an epoch in a CUDA graph is later work.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .simulator import (ByzSGDSimulator, SimState,
                        coordinatewise_diameter_sum, l2_diameter)


class EpochEngine:
    """Fused epochs around a :class:`ByzSGDSimulator`.

    ``acc_fn(flat_params [D], eval_x, eval_y)`` with ``eval_set=(ex, ey)``
    enables per-step accuracy of server 0 on the stride ``metrics_every``;
    ``track_delta`` adds the Lemma 4.2/4.3 diameters (``delta_pre`` just
    before the boundary gather would apply, ``delta``/``l2_diam`` on the
    post-step state). The sync variant always reports per-worker
    ``rejects``. Metrics come back as host numpy buffers ``[steps]``
    (``[steps, n_w]`` for rejects).
    """

    def __init__(self, sim: ByzSGDSimulator, *, acc_fn: Callable | None = None,
                 eval_set: tuple | None = None, track_delta: bool = False,
                 metrics_every: int = 1):
        if (acc_fn is None) != (eval_set is None):
            raise ValueError("acc_fn and eval_set must be given together")
        if metrics_every < 1:
            raise ValueError("metrics_every must be >= 1")
        self.sim = sim
        self.cfg = sim.cfg
        self.acc_fn = acc_fn
        self.eval_set = eval_set
        self.track_delta = track_delta
        self.metrics_every = metrics_every

    def run_epoch(self, state: SimState, batches, bufs: dict, at: int):
        """L steps over ``batches`` (a tuple of ``[L, n_w, ...]`` tensors),
        writing step ``at + i``'s metrics into ``bufs`` on the device."""
        sim, cfg = self.sim, self.cfg
        h = cfg.h_servers
        L = batches[0].shape[0]
        for i in range(L):
            batch = tuple(b[i] for b in batches)
            if cfg.variant == "sync":
                delta_pre = (coordinatewise_diameter_sum(state.params, h)
                             if self.track_delta else None)
                if state.t % cfg.T == 0 and state.t > 0:
                    state = sim.sync_gather_step(state)
                state, diag = sim.sync_step(state, batch)
                bufs["rejects"][at + i] = diag["rejects"]
            else:
                state = sim.scatter_step(state, batch)
                delta_pre = (coordinatewise_diameter_sum(state.params, h)
                             if self.track_delta else None)
                if state.t % cfg.T == 0:
                    state = sim.gather_step(state)
            k = at + i
            if self.acc_fn is not None and (state.t - 1) % \
                    self.metrics_every == 0:
                bufs["acc"][k] = self.acc_fn(state.params[0],
                                             *self.eval_set)
            if self.track_delta:
                bufs["delta_pre"][k] = delta_pre
                bufs["delta"][k] = coordinatewise_diameter_sum(state.params,
                                                               h)
                bufs["l2_diam"][k] = l2_diameter(state.params, h)
        return state

    def run(self, state: SimState, batches=None, *, stream=None,
            steps: int | None = None, epoch_steps: int | None = None):
        """Run ``steps`` protocol steps in epochs of ``epoch_steps`` (default
        T). Feed either ``batches`` — a tuple of ``[steps, n_w, ...]``
        tensors — or ``stream`` — an object with ``next(L)`` returning such a
        tuple for L steps. Returns the final state and the host metric
        buffers (one transfer)."""
        if (batches is None) == (stream is None):
            raise ValueError("provide exactly one of batches/stream")
        if steps is None:
            if batches is None:
                raise ValueError("steps is required with stream input")
            steps = batches[0].shape[0]
        dev = state.params.device
        names = (["acc"] if self.acc_fn is not None else []) + (
            ["delta_pre", "delta", "l2_diam"] if self.track_delta else [])
        bufs = {k: torch.zeros(steps, dtype=torch.float32, device=dev)
                for k in names}
        if self.cfg.variant == "sync":
            bufs["rejects"] = torch.zeros((steps, self.cfg.n_workers),
                                          dtype=torch.float32, device=dev)
        L = epoch_steps or self.cfg.T
        done = 0
        while done < steps:
            n = min(L, steps - done)
            chunk = (tuple(b[done:done + n] for b in batches)
                     if batches is not None else stream.next(n))
            state = self.run_epoch(state, chunk, bufs, done)
            done += n
        if not bufs:
            return state, {}
        keys = list(bufs)
        host = torch.cat([bufs[k].reshape(-1) for k in keys]).cpu().numpy()
        out, off = {}, 0
        for k in keys:
            size = bufs[k].numel()
            out[k] = host[off:off + size].reshape(tuple(bufs[k].shape))
            off += size
        if "rejects" in out:
            out["rejects"] = out["rejects"].astype(np.int32)
        return state, out

"""``repro_torch.exp.run`` — one entry point for the ported runners:

  * ``stepwise`` — the per-step ``ByzSGDSimulator.run`` reference loop
    (host batch iterator, host metrics);
  * ``fused``    — :class:`repro_torch.core.engine.EpochEngine` (device batch
    stream, epochs of T steps, device metric buffers, one host transfer).

Both return a uniform :class:`RunResult`, as ``repro.exp.run`` does. The run
goes to the GPU unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import os
import subprocess
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from .. import device as _device
from ..core.engine import EpochEngine
from ..core.simulator import coordinatewise_diameter_sum, l2_diameter
from ..data.pipeline import DeviceBatchStream, classification_stream
from . import presets
from .spec import Experiment


def git_sha() -> str | None:
    """Current repo revision, or None outside a git checkout."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10, cwd=os.path.dirname(os.path.abspath(__file__)))
        return out.stdout.strip() or None if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        return None


def provenance(spec_hash: str | None, dev: torch.device) -> dict[str, Any]:
    """The provenance block of a result: spec, code and device."""
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)
    return {"spec_hash": spec_hash, "git_sha": git_sha(),
            "torch_version": torch.__version__, "device": dev.type,
            "device_kind": kind}


@dataclass
class RunResult:
    """Uniform result of :func:`run`: strided ``logs``, ``final`` metrics,
    ``wall_s`` and ``provenance`` serialize via :meth:`to_dict`; ``state``
    (the final ``SimState``) and ``buffers`` (the fused runner's dense
    per-step metric buffers) are runtime attachments."""
    experiment: Experiment
    logs: list[dict]
    final: dict
    wall_s: float
    provenance: dict
    state: Any = field(default=None, repr=False, compare=False)
    buffers: dict | None = field(default=None, repr=False, compare=False)

    def to_dict(self) -> dict[str, Any]:
        return {"experiment": self.experiment.to_dict(), "logs": self.logs,
                "final": self.final, "wall_s": self.wall_s,
                "provenance": self.provenance}

    def summary(self) -> str:
        e = self.experiment
        return "  ".join([f"[{e.name}] runner={e.runner}",
                          f"steps={e.steps}",
                          f"final acc {self.final.get('acc', float('nan')):.3f}",
                          f"wall {self.wall_s:.1f}s", f"spec {e.spec_hash}"])


def run(experiment: Experiment | str, *, device=None,
        **overrides) -> RunResult:
    """Run an experiment (or a preset name, with field overrides) through
    its declared runner on ``device`` (the GPU unless ``"cpu"`` is
    asked)."""
    if isinstance(experiment, str):
        e = presets.get(experiment, **overrides)
    else:
        e = experiment.replace(**overrides) if overrides else experiment
    dev = _device.resolve(device)
    if e.runner == "stepwise":
        return _run_stepwise(e, dev)
    return _run_fused(e, dev)


def _accuracy(sim, acc):
    """Accuracy of a flat model ``[D]`` on ``(x, y)``."""
    def fn(flat, x, y):
        return acc(sim.tree.unflatten(flat), x, y)
    return fn


def _final_metrics(e: Experiment, sim, state, acc_flat, eval_set,
                   mbuf=None) -> dict:
    h = sim.cfg.h_servers
    final = {"acc": float(acc_flat(state.params[0], *eval_set))}
    if e.track_delta:
        final["delta"] = float(coordinatewise_diameter_sum(state.params, h))
        final["l2_diam"] = float(l2_diameter(state.params, h))
    if mbuf is not None and "rejects" in mbuf:
        final["rejects"] = int(np.asarray(mbuf["rejects"][-1]).sum())
    return final


def _run_stepwise(e: Experiment, dev: torch.device) -> RunResult:
    sim = e.build_sim(device=dev)
    h = sim.cfg.h_servers
    acc = _accuracy(sim, e.build_problem()[2])
    state = sim.init_state(e.seed)
    stream, eval_fn = classification_stream(e.seed, e.mixture,
                                            sim.cfg.n_workers, e.batch,
                                            e.steps, dev)
    ex, ey = eval_fn(e.eval_n)

    def metrics(s):
        m = {"acc": float(acc(s.params[0], ex, ey))}
        if e.track_delta:
            m["delta"] = float(coordinatewise_diameter_sum(s.params, h))
            m["l2_diam"] = float(l2_diameter(s.params, h))
        return m

    t0 = time.time()
    state, logs = sim.run(state, stream, metrics_fn=metrics,
                          metrics_every=e.metrics_every)
    _device.synchronize(dev)
    wall = time.time() - t0
    final = _final_metrics(e, sim, state, acc, (ex, ey))
    return RunResult(e, logs, final, wall, provenance(e.spec_hash, dev),
                     state=state)


def _run_fused(e: Experiment, dev: torch.device) -> RunResult:
    sim = e.build_sim(device=dev)
    acc = _accuracy(sim, e.build_problem()[2])
    state = sim.init_state(e.seed)
    stream = DeviceBatchStream(e.seed, e.mixture, sim.cfg.n_workers, e.batch,
                               dev)
    ex, ey = stream.eval_set(e.eval_n)
    eng = EpochEngine(sim, acc_fn=acc, eval_set=(ex, ey),
                      track_delta=e.track_delta,
                      metrics_every=e.metrics_every)
    t0 = time.time()
    state, mbuf = eng.run(state, stream=stream, steps=e.steps,
                          epoch_steps=e.epoch_steps)
    wall = time.time() - t0

    logs = []
    for i in range(0, e.steps, e.metrics_every):
        m = {"step": i, "acc": float(mbuf["acc"][i])}
        if e.track_delta:
            m["delta"] = float(mbuf["delta"][i])
            m["l2_diam"] = float(mbuf["l2_diam"][i])
        if "rejects" in mbuf:
            m["rejects"] = int(np.asarray(mbuf["rejects"][i]).sum())
        logs.append(m)
    final = _final_metrics(e, sim, state, acc, (ex, ey), mbuf)
    return RunResult(e, logs, final, wall, provenance(e.spec_hash, dev),
                     state=state, buffers=mbuf)

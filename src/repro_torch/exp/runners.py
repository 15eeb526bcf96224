"""``repro_torch.exp.run`` — one entry point for the ported runners:

  * ``stepwise`` — the per-step ``ByzSGDSimulator.run`` reference loop
    (host batch iterator, host metrics);
  * ``fused``    — :class:`repro_torch.core.engine.EpochEngine` (device batch
    stream, epochs of T steps, device metric buffers, one host transfer);
  * ``netsim``   — a trace-driven run: the named netsim scenario is simulated
    first (host numpy), its realized quorums and staleness replay through
    ``TraceDelivery`` (tables staged on the run's device) in the fused
    runner, and the cluster's accounting rides along in the result;
  * ``protocol`` — the spec lowered to ``ProtocolConfig`` (G = n_workers =
    n_servers co-located groups) and run through
    :class:`repro_torch.core.protocol.ProtocolEngine` on one device: the MLP
    problems on the mixture stream, the zoo archs on the token stream with
    the negative eval loss as their ``acc``.

Delivery is orthogonal to the runner: a ``delivery="trace"`` experiment
trains stepwise, fused or through the protocol over the realized trace. All
return a uniform :class:`RunResult`, as ``repro.exp.run`` does. The run
goes to the GPU unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import json
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
from ..data.pipeline import (DeviceBatchStream, DeviceTokenStream,
                             classification_stream)
from . import presets
from .spec import DATA, NOT_PORTED, Experiment, is_arch_model


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
    ``wall_s``, ``provenance`` and (trace-delivered runs) the ``netsim``
    cluster accounting serialize via :meth:`to_dict`; ``state`` (the final
    ``SimState``) and ``buffers`` (the fused runner's dense per-step metric
    buffers) are runtime attachments."""
    experiment: Experiment
    logs: list[dict]
    final: dict
    wall_s: float
    provenance: dict
    netsim: dict | None = None
    state: Any = field(default=None, repr=False, compare=False)
    buffers: dict | None = field(default=None, repr=False, compare=False)

    def to_dict(self) -> dict[str, Any]:
        out = {"experiment": self.experiment.to_dict(), "logs": self.logs,
               "final": self.final, "wall_s": self.wall_s,
               "provenance": self.provenance}
        if self.netsim is not None:
            out["netsim"] = self.netsim
        return out

    def summary(self) -> str:
        e = self.experiment
        bits = [f"[{e.name}] runner={e.runner}", f"steps={e.steps}",
                f"final acc {self.final.get('acc', float('nan')):.3f}",
                f"wall {self.wall_s:.1f}s", f"spec {e.spec_hash}"]
        if self.netsim is not None:
            bits.append(f"virtual {self.netsim['virtual_ms']:.0f}ms "
                        f"(shortfalls {self.netsim['shortfalls']})")
        return "  ".join(bits)


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
    # runner="netsim" is fused + trace with the cluster accounting attached
    # (delivery normalized at construction)
    delivery, info = (_trace_delivery(e, dev) if e.delivery == "trace"
                      else (None, None))
    if e.runner == "stepwise":
        return _run_stepwise(e, dev, delivery, info)
    if e.runner == "protocol":
        return _run_protocol(e, dev, delivery, info)
    return _run_fused(e, dev, delivery, info)


def _trace_delivery(e: Experiment, dev: torch.device):
    """Simulate the named scenario; return (TraceDelivery on ``dev``,
    netsim dict)."""
    from ..netsim import ClusterSim
    sc = e.to_scenario()
    trace = ClusterSim(sc).run()
    step_ms = np.diff(np.maximum.accumulate(trace.step_done_ms), prepend=0.0)
    info = {
        "scenario": sc.name, "steps": int(sc.steps),
        "virtual_ms": float(trace.step_done_ms[-1]),
        "mean_step_ms": float(step_ms.mean()),
        "p95_step_ms": float(np.percentile(step_ms, 95)),
        "mean_pull_staleness_ms": float(trace.pull_stale.mean()),
        "events": int(trace.events), "shortfalls": int(trace.shortfalls),
        "totals": trace.ledger.totals(),
        "summary": trace.ledger.summary(sc),
    }
    return trace.to_delivery(dev), info


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


def _run_stepwise(e: Experiment, dev: torch.device, delivery=None,
                  netsim=None) -> RunResult:
    sim = e.build_sim(delivery, device=dev)
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
                     netsim=netsim, state=state)


def _run_fused(e: Experiment, dev: torch.device, delivery=None,
               netsim=None) -> RunResult:
    sim = e.build_sim(delivery, device=dev)
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
        stal = sim.delivery.staleness(i)
        if stal:
            m.update(stal)
        logs.append(m)
    final = _final_metrics(e, sim, state, acc, (ex, ey), mbuf)
    return RunResult(e, logs, final, wall, provenance(e.spec_hash, dev),
                     netsim=netsim, state=state, buffers=mbuf)


def _lm_acc(bundle):
    """LM metric under the runners' uniform ``acc`` key: the NEGATIVE eval
    loss (higher is better, like accuracy)."""

    def acc(params, tokens, labels):
        return -bundle.loss(params, {"tokens": tokens, "labels": labels})

    return acc


def _run_protocol(e: Experiment, dev: torch.device, delivery=None,
                  netsim=None) -> RunResult:
    from ..core.protocol import ProtocolEngine
    pcfg = e.to_protocol_config()
    if e.ckpt_every:
        raise NotImplementedError(
            f"experiment {e.name!r} sets ckpt_every={e.ckpt_every}: "
            f"{NOT_PORTED['ckpt']} is not ported yet")
    bundle = e.build_bundle()
    G = pcfg.n_groups
    if is_arch_model(e.model):
        stream = DeviceTokenStream(e.seed, DATA[e.data], G, e.batch, dev)
        acc = _lm_acc(bundle)
    else:
        acc = e.build_problem()[2]
        stream = DeviceBatchStream(e.seed, e.mixture, G, e.batch, dev)
    ex, ey = stream.eval_set(e.eval_n)
    eng = ProtocolEngine(
        bundle, pcfg, e.build_schedule(), delivery=delivery,
        with_attack=bool(e.byz.worker_attack or e.byz.server_attack),
        acc_fn=acc, eval_set=(ex, ey), track_delta=e.track_delta,
        metrics_every=e.metrics_every, device=dev)
    state = eng.init_state(e.seed)
    t0 = time.time()
    state, mbuf = eng.run(state, stream=stream, steps=e.steps,
                          epoch_steps=e.epoch_steps)
    _device.synchronize(dev)
    wall = time.time() - t0

    logs = []
    for i in range(0, e.steps, e.metrics_every):
        m = {"step": i, "acc": float(mbuf["acc"][i])}
        if e.track_delta:
            m["delta"] = float(mbuf["delta"][i])
            m["l2_diam"] = float(mbuf["l2_diam"][i])
        stal = eng.delivery.staleness(i)
        if stal:
            m.update(stal)
        logs.append(m)
    h = G - e.byz.n_byz_servers
    final = {"acc": float(eng._acc(state))}
    if e.track_delta:
        final["delta"] = float(coordinatewise_diameter_sum(state.params, h))
        final["l2_diam"] = float(l2_diameter(state.params, h))
    prov = provenance(e.spec_hash, dev)
    prov["mesh"] = {"rep": 1, "fsdp": 1, "model": 1}
    prov["protocol_engine"] = pcfg.engine
    return RunResult(e, logs, final, wall, prov, netsim=netsim, state=state,
                     buffers=mbuf)


def write_result(res: RunResult, out_dir: str = "results/benchmarks",
                 name: str | None = None) -> str:
    """Write a RunResult verbatim as JSON; returns the path."""
    os.makedirs(out_dir, exist_ok=True)
    base = name or f"exp_{res.experiment.name.replace('/', '_')}" \
                   f"_{res.experiment.runner}"
    path = os.path.join(out_dir, base + ".json")
    with open(path, "w") as fh:
        json.dump(res.to_dict(), fh, indent=1, default=float)
    return path

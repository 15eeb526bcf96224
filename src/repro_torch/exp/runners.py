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
    :class:`repro_torch.core.protocol.ProtocolEngine` on the
    ``make_protocol_mesh(G)`` mesh of the initialised ``torch.distributed``
    world (one device without one): the MLP problems on the mixture
    stream, the zoo archs on the token stream with the negative eval loss
    as their ``acc``; with ``ckpt_every`` the run is chunked at the
    checkpoint boundaries and saved at each;
  * ``elastic``  — the protocol chunked at the membership boundaries of the
    spec's plan (or of the named scenario's realized crash windows), each
    segment on the reference's mesh for its fleet over the initialised
    world's first ranks (the rest idle): the ``[G, P]`` stack re-formed
    across the ranks at each boundary, joiners seeded from the survivors'
    median, checkpointed resume.

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
from .spec import DATA, Experiment, is_arch_model


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
    if e.runner == "elastic":
        return _run_elastic(e, dev)
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


def _need_ckpt_dir(e: Experiment) -> None:
    if e.ckpt_every and not e.ckpt_dir:
        raise ValueError(
            f"experiment {e.name!r} sets ckpt_every={e.ckpt_every} "
            "but no ckpt_dir; pass one at run time, e.g. "
            'exp.run(name, ckpt_dir="...")')


def _concat(bufs: list[dict]) -> dict:
    """Per-chunk metric buffers -> one buffer per metric over the run."""
    return ({k: np.concatenate([b[k] for b in bufs]) for k in bufs[0]}
            if bufs else {})


def _run_protocol(e: Experiment, dev: torch.device, delivery=None,
                  netsim=None) -> RunResult:
    from ..core.protocol import ProtocolEngine
    from ..launch.mesh import make_protocol_mesh
    pcfg = e.to_protocol_config()
    _need_ckpt_dir(e)
    bundle = e.build_bundle()
    G = pcfg.n_groups
    mesh = make_protocol_mesh(G)
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
        metrics_every=e.metrics_every, device=dev, mesh=mesh)
    state = eng.init_state(e.seed)
    t0 = time.time()
    if e.ckpt_every:
        # chunks at the checkpoint boundaries: the gather cadence and the
        # metric stride ride on the state's step counter, so the chunked run
        # is the one-call run
        from ..checkpoint import checkpointer as ck
        bufs, done = [], 0
        while done < e.steps:
            n = min(e.ckpt_every, e.steps - done)
            state, b = eng.run(state, stream=stream, steps=n,
                               epoch_steps=e.epoch_steps)
            bufs.append(b)
            done += n
            ck.save(e.ckpt_dir, done, state)
        mbuf = _concat(bufs)
    else:
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
    final = {"acc": float(eng._acc(state))}
    if e.track_delta:
        final["delta"], final["l2_diam"] = map(float, eng.diameters(state))
    prov = provenance(e.spec_hash, dev)
    prov["mesh"] = mesh.sizes
    prov["protocol_engine"] = pcfg.engine
    return RunResult(e, logs, final, wall, prov, netsim=netsim, state=state,
                     buffers=mbuf)


# (G, world size) -> (the world's process group, the segment mesh of G groups
# on it): a regrow to an earlier fleet size, and a later run in the same
# world, reuse the mesh and its process groups, as the reference's
# ``_protocol_mesh`` keeps one mesh per (G, device count). A world made anew
# (another default group) makes its meshes anew.
_MESH_CACHE: dict[tuple, tuple] = {}


def _segment_mesh(G: int):
    import torch.distributed as dist

    from ..launch.mesh import make_segment_mesh
    world = dist.group.WORLD if dist.is_initialized() else None
    key = (G, dist.get_world_size() if world is not None else 1)
    hit = _MESH_CACHE.get(key)
    if hit is None or hit[0] is not world:
        hit = _MESH_CACHE[key] = (world, make_segment_mesh(G))
    return hit[1]


class _GroupView:
    """Width-adapted view of a :class:`DeviceBatchStream`: the epoch's
    active-group count of rows per step, drawn at the launch width (see
    ``DeviceBatchStream.next``), so the data sequence stays aligned with the
    global step counter across membership changes."""

    def __init__(self, base: DeviceBatchStream, n_groups: int):
        self.base = base
        self.n_groups = n_groups

    def next(self, length: int):
        return self.base.next(length, n_workers=self.n_groups)


def _run_elastic(e: Experiment, dev: torch.device) -> RunResult:
    """Join/leave-tolerant protocol training (``runner="elastic"``).

    The run is chunked at every membership boundary of the plan (authored
    in the spec, or lowered from the named netsim scenario's realized crash
    windows). At each boundary the resilience parameters are re-derived for
    the new fleet (:func:`~repro_torch.core.membership.epoch_config`, Table
    1 re-validated), a new ``ProtocolEngine`` takes over on the segment's
    mesh, the ``[G, P]`` stack and the optimizer's rows are re-stacked onto
    it (:func:`~repro_torch.core.membership.reform_state`: joiners seeded
    from the survivors' median), and with a ``ckpt_dir`` the re-formed
    state is saved. A run with a ``ckpt_dir`` resumes from its latest
    checkpoint, whose ``meta["active"]`` names the fleet it was saved
    under. With an empty plan the run is ``runner="protocol"`` bit for
    bit.

    In a ``torch.distributed`` world of W ranks every rank calls it. A
    segment of G' groups runs on ``make_segment_mesh(G')``, the
    reference's ``(rep, fsdp, 1)`` on the first ``rep * K`` ranks; the
    others sit it out, advancing only the batch stream, and take the run's
    counters and generator from rank 0 when they join. Every rank returns
    rank 0's ``logs``, ``final``, ``buffers`` and ``provenance``, and its
    own block of the last segment as ``state`` (``protocol.whole_state``,
    called on every rank, gives each the whole stack)."""
    import dataclasses as _dc

    import torch.distributed as dist

    from ..checkpoint import checkpointer as ck
    from ..core import membership as _membership
    from ..core.protocol import ProtocolEngine, share_run_state

    pcfg0 = e.to_protocol_config()
    G0 = pcfg0.n_groups
    sync = e.variant == "sync"

    plan, plan_source, netsim = e.membership_plan, "spec", None
    if plan is None and e.scenario is not None:
        from ..netsim import ClusterSim
        sc = e.to_scenario()
        trace = ClusterSim(sc).run()
        plan = _membership.plan_from_trace(sc, trace)
        plan_source = f"scenario:{e.scenario}"
        netsim = {"scenario": sc.name, "steps": int(sc.steps),
                  "virtual_ms": float(trace.step_done_ms[-1]),
                  "events": int(trace.events),
                  "shortfalls": int(trace.shortfalls)}
    if plan is None:
        plan = _membership.MembershipPlan()
    if not plan.events:
        plan_source = "static" if plan_source == "spec" else plan_source
    segs = plan.epochs(G0, e.steps)

    bundle = e.build_bundle()
    acc = e.build_problem()[2]
    stream = DeviceBatchStream(e.seed, e.mixture, G0, e.batch, dev)
    ex, ey = stream.eval_set(e.eval_n)
    with_attack = bool(e.byz.worker_attack or e.byz.server_attack)
    _need_ckpt_dir(e)

    # resume: the latest checkpoint's meta names the active set it was saved
    # under (a runner="protocol" checkpoint has none: the launch fleet)
    start, resume_active = 0, None
    if e.ckpt_dir:
        latest = ck.latest_step(e.ckpt_dir)
        if latest is not None:
            start = int(latest)
            if start > e.steps:
                raise ValueError(
                    f"checkpoint at step {start} under {e.ckpt_dir!r} is "
                    f"beyond this run (steps={e.steps}); wrong ckpt_dir?")
            meta = ck.read_manifest(e.ckpt_dir, start).get("meta") or {}
            resume_active = tuple(int(g) for g in
                                  meta.get("active", range(G0)))

    def _save(step: int, state, active) -> None:
        ck.save(e.ckpt_dir, step, state,
                meta={"elastic": True, "active": [int(g) for g in active],
                      "n_groups_launch": G0, "spec_hash": e.spec_hash})

    state, prev_active, bufs, eng, mesh = None, None, [], None, None
    t0 = time.time()
    for seg in segs:
        if seg.stop <= start and seg.stop < e.steps:
            continue  # fully replayed by the checkpoint (keep the last seg)
        pcfg = _membership.epoch_config(pcfg0, seg.active, synchronous=sync)
        mesh = _segment_mesh(pcfg.n_groups)
        eng = ProtocolEngine(
            bundle, pcfg, e.build_schedule(), with_attack=with_attack,
            acc_fn=acc, eval_set=(ex, ey), track_delta=e.track_delta,
            metrics_every=e.metrics_every, device=dev, mesh=mesh)
        if state is None:
            state = eng.init_state(e.seed)
            if start > 0:
                if resume_active != seg.active:
                    raise ValueError(
                        f"checkpoint at step {start} was saved with active "
                        f"groups {resume_active}, but this plan's epoch "
                        f"there has {seg.active} — the checkpoint does not "
                        "belong to this membership plan")
                state, _ = ck.restore(e.ckpt_dir, start, state, dev)
                stream.skip(start)
        elif prev_active != seg.active:
            state = _membership.reform_state(state, prev_active, seg.active,
                                             mesh, pcfg0.chunk_bytes)
            if e.ckpt_dir:
                # overwrites the chunk save at this step: a resume of THIS
                # epoch restores the re-formed state
                _save(seg.start, state, seg.active)
        prev_active = seg.active

        seg_stream = _GroupView(stream, pcfg.n_groups)
        done = max(seg.start, start)
        while done < seg.stop:
            n = seg.stop - done
            if e.ckpt_every:
                n = min(n, e.ckpt_every - done % e.ckpt_every)
            if mesh.member:
                state, b = eng.run(state, stream=seg_stream, steps=n,
                                   epoch_steps=e.epoch_steps)
                bufs.append(b)
            else:
                stream.skip(n)    # idle: keep the batch stream in step
            done += n
            if e.ckpt_every:
                _save(done, state, seg.active)
    if e.ckpt_dir and not e.ckpt_every and start < e.steps:
        _save(e.steps, state, prev_active)
    _device.synchronize(dev)
    wall = time.time() - t0

    out = None
    if mesh.member:
        prov = provenance(e.spec_hash, dev)
        prov["mesh"] = mesh.sizes
        prov["protocol_engine"] = pcfg0.engine
        prov["membership"] = {
            "plan_source": plan_source,
            "events": [_dc.asdict(ev) for ev in plan.events],
            "epochs": [{"start": s.start, "stop": s.stop,
                        "active": list(s.active)} for s in segs],
            "resumed_at": start or None,
        }
        out = (*_elastic_results(e, eng, state, bufs, start), prov)
    if mesh.world > 1:
        # the last segment's idle ranks take rank 0's counters, generator
        # and results
        state = share_run_state(state, mesh.world, "metrics")
        box = [out]
        dist.broadcast_object_list(box, src=0)
        out = box[0]
    logs, final, mbuf, prov = out
    return RunResult(e, logs, final, wall, prov, netsim=netsim, state=state,
                     buffers=mbuf)


def _elastic_results(e: Experiment, eng, state, bufs: list, start: int):
    """(logs, final, buffers) of an elastic run, on the last segment's
    ranks (its metrics are collectives of that mesh)."""
    mbuf = _concat(bufs)
    logs = []
    if "acc" in mbuf:
        # buffer index j is global step start + j; acc lands where the
        # global step hits the metrics_every stride
        for j in range((-start) % e.metrics_every, len(mbuf["acc"]),
                       e.metrics_every):
            m = {"step": start + j, "acc": float(mbuf["acc"][j])}
            if e.track_delta:
                m["delta"] = float(mbuf["delta"][j])
                m["l2_diam"] = float(mbuf["l2_diam"][j])
            logs.append(m)
    final = {"acc": float(eng._acc(state))}
    if e.track_delta:
        final["delta"], final["l2_diam"] = map(float, eng.diameters(state))
    return logs, final, mbuf


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

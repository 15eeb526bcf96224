"""Subprocess body of ``tests/test_torch_elastic_dist.py``: the port's
elastic runner (``runner="elastic"``) over gloo ranks on the CPU, spawned
by ``torch.multiprocessing``. Imports no JAX: the parent hands in the
replayed quorum tables, numpy batches and initial state (``inputs.npz``)
and compares what this writes beside them with JAX's one-device elastic
run and the port's one-rank run.

    python tests/_torch_elastic_runner.py <dir>

One spawn per world, W = 8 and W = 5; on each rank of each:

1. ``elastic/planned_churn`` on the replay (the tables of each fleet size,
   the numpy batches, the parent's initial state);
2. the preset as registered (its own generator and batch stream), with
   SGD and, on W = 8, AdamW: uninterrupted, with ``ckpt_every=4``, and
   killed after step 12 (the saves past it deleted) and resumed;
3. on W = 5, ``runner="protocol"`` at G = 4, which the world's fifth rank
   has no place in (refused), and a collective on the rank that sits the
   G' = 4 segment out (refused).

Each run records, on every rank: each segment's mesh and whether the rank
is in it; every MDA selection; each scatter step's ``pull`` +
``aggregate`` bytes beside ``collective_volume_bytes`` on the rank's
columns; at each boundary the ``reform`` bytes beside
``reform_volume_bytes``, and whether the re-formed whole stacks are
bit-equal to ``reform_params`` of the incoming whole stacks; the bytes sent
inside each segment; the results, the step counter and the generator's
state; and the whole final stacks (``whole_state``, on every rank).
"""
import contextlib
import hashlib
import json
import os
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import exp  # noqa: E402
from repro_torch.checkpoint import checkpointer as ck  # noqa: E402
from repro_torch.core import membership as tmem  # noqa: E402
from repro_torch.core import protocol as tproto  # noqa: E402
from repro_torch.core.quorum import TraceDelivery  # noqa: E402
from repro_torch.exp import runners as truns  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402

PRESET = "elastic/planned_churn"


class Replay:
    """The parent's inputs: quorum tables by (G, q_w, q_ps), batches at
    the launch width, the eval set and the initial ``[G, P]`` stack."""

    def __init__(self, d: Path):
        z = np.load(d / "inputs.npz")
        self.x, self.y = z["x"], z["y"]
        self.ex, self.ey = z["ex"], z["ey"]
        self.params0 = z["params0"]
        self.tables = {}
        for name in z.files:
            if name.startswith("pull_"):
                key = name[len("pull_"):]
                self.tables[tuple(int(v) for v in key.split("_"))] = (
                    z[f"pull_{key}"], z[f"push_{key}"], z[f"gather_{key}"])

    def stream(self):
        replay = self

        def to(a):
            t = torch.from_numpy(np.ascontiguousarray(a))
            return t.long() if a.dtype == np.int32 else t

        class Stream:
            def __init__(self, *a, **k):
                self.i = 0

            def eval_set(self, n):
                return to(replay.ex), to(replay.ey)

            def next(self, length, n_workers=None):
                nw = n_workers or replay.x.shape[1]
                sl = slice(self.i, self.i + length)
                self.i += length
                return to(replay.x[sl, :nw]), to(replay.y[sl, :nw])

            def skip(self, length):
                self.i += length

        return Stream


class Probe:
    """Hooks on one rank for one run (installed by :meth:`installed`)."""

    def __init__(self, rank: int, replay: Replay | None = None):
        self.rank = rank
        self.replay = replay
        self.segments = []        # (mesh sizes, member) per segment
        self.sel = []
        self.steps = []
        self.boundaries = []
        self.marks = []           # bytes sent before / after each boundary

    @staticmethod
    def total() -> int:
        """Bytes this rank has sent on every segment mesh of the world."""
        return sum(sum(m.sent.values())
                   for _, m in truns._MESH_CACHE.values())

    @contextlib.contextmanager
    def installed(self):
        probe = self
        seg_mesh, qw = truns._segment_mesh, tproto.quorum_weights
        reform, engine = tmem.reform_state, tproto.ProtocolEngine
        stream = truns.DeviceBatchStream

        def segment_mesh(G):
            mesh = seg_mesh(G)
            probe.segments.append((mesh.sizes, mesh.member))
            return mesh

        def record(*a):
            w = qw(*a)
            probe.sel.append(w.numpy().copy())
            return w

        class Engine(engine):
            def __init__(self, bundle, pcfg, lr, **kw):
                if probe.replay is not None:
                    kw["delivery"] = TraceDelivery(
                        *probe.replay.tables[(pcfg.n_groups, pcfg.q_workers,
                                              pcfg.q_servers)],
                        T=pcfg.T, device="cpu")
                super().__init__(bundle, pcfg, lr, **kw)
                scatter, mesh = self.scatter, self.mesh

                def counted(state, batch):
                    before = mesh.sent["pull"] + mesh.sent["aggregate"]
                    out = scatter(state, batch)
                    cols = state.params.shape[1]
                    probe.steps.append({
                        "t": state.t, "mesh": mesh.sizes, "cols": cols,
                        "got": mesh.sent["pull"] + mesh.sent["aggregate"]
                        - before,
                        "want": tproto.collective_volume_bytes(
                            pcfg, cols, rep=mesh.size("rep"))})
                    return out

                self.scatter = counted

            def init_state(self, seed):
                if probe.replay is None:
                    return super().init_state(seed)
                tree = super().init_state(seed).tree
                params = torch.from_numpy(probe.replay.params0.copy())
                whole = tproto.ByzState(
                    params=params, t=0,
                    gen=torch.Generator().manual_seed(seed + 1), opt=(),
                    tree=tree)
                return tproto.shard_state(whole, self.mesh)

        def reform_state(state, old_active, new_active, mesh=None,
                         chunk_bytes=256 * 2**20):
            probe.marks.append(probe.total())
            old = state.mesh
            before = tproto.whole_state(state, tag="probe")
            sent = old.sent["reform"]
            out = reform(state, old_active, new_active, mesh, chunk_bytes)
            sent = old.sent["reform"] - sent
            after = tproto.whole_state(out, tag="probe")
            stacks = [("params", before.params, after.params)]
            if before.opt:
                stacks += [("m", before.opt.m, after.opt.m),
                           ("v", before.opt.v, after.opt.v)]
            equal = {name: torch.equal(b, tmem.reform_params(
                a, old_active, new_active, chunk_bytes))
                for name, a, b in stacks}
            G, P = before.params.shape
            probe.boundaries.append({
                "old": old.sizes, "new": mesh.sizes, "G": G,
                "G_new": len(new_active), "equal": equal, "sent": sent,
                "want": tmem.reform_volume_bytes(
                    old.shape, mesh.shape, G, P,
                    before.params.element_size(), rank=probe.rank,
                    stacks=len(stacks),
                    run_state_bytes=state.gen.get_state().numel() + 16),
                "block": list(out.params.shape)})
            probe.marks.append(probe.total())
            return out

        truns._segment_mesh = segment_mesh
        tproto.quorum_weights = record
        tmem.reform_state = reform_state
        tproto.ProtocolEngine = Engine
        if self.replay is not None:
            truns.DeviceBatchStream = self.replay.stream()
        try:
            yield self
        finally:
            truns._segment_mesh = seg_mesh
            tproto.quorum_weights = qw
            tmem.reform_state = reform
            tproto.ProtocolEngine = engine
            truns.DeviceBatchStream = stream


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def _run(d: Path, rank: int, tag: str, replay=None, **kw):
    """One elastic run on this rank under a probe; writes ``<tag>_<rank>``
    (.json: the probe's records and the results; .npz: the whole final
    stacks and the selections)."""
    probe = Probe(rank, replay)
    with probe.installed():
        probe.marks.append(probe.total())
        t0 = time.perf_counter()
        res = exp.run(PRESET, device="cpu", **kw)
        wall = time.perf_counter() - t0
        probe.marks.append(probe.total())
        whole = tproto.whole_state(res.state)
    # bytes inside each segment: from the previous boundary's end (or the
    # run's start) to the next boundary's start (or the run's end)
    seg_sent = [b - a for a, b in zip(probe.marks[::2], probe.marks[1::2])]
    rec = {
        "segments": probe.segments, "steps": probe.steps,
        "boundaries": probe.boundaries, "segment_sent": seg_sent,
        "block": list(res.state.params.shape), "logs": res.logs,
        "final": res.final, "provenance": res.provenance,
        "buffers": {k: v.tolist() for k, v in (res.buffers or {}).items()},
        "t": res.state.t, "whole_t": whole.t,
        "gen": _digest(res.state.gen.get_state()),
        "count": res.state.opt.count if res.state.opt else None,
        "wall": wall}
    with open(d / f"{tag}_{rank}.json", "w") as fh:
        json.dump(rec, fh)
    arrays = {"params": whole.params.numpy()}
    if whole.opt:
        arrays.update(m=whole.opt.m.numpy(), v=whole.opt.v.numpy())
    for i, s in enumerate(probe.sel):
        arrays[f"sel{i}"] = s
    np.savez(d / f"{tag}_{rank}.npz", **arrays)
    return res


def _resume(d: Path, rank: int, world: int, opt: str):
    """``ckpt_every=4`` to the end, the saves past step 12 deleted (a kill
    after step 12), and the run again from there."""
    ckdir = d / f"ck_w{world}_{opt}"
    _run(d, rank, f"w{world}_{opt}_ckpt", ckpt_dir=str(ckdir), ckpt_every=4,
         optimizer=opt)
    dist.barrier()
    if rank == 0:
        for name in os.listdir(ckdir):
            if int(name.split("_")[-1]) > 12:
                shutil.rmtree(ckdir / name)
        with open(d / f"w{world}_{opt}_meta12.json", "w") as fh:
            json.dump(ck.read_manifest(str(ckdir), 12).get("meta"), fh)
    dist.barrier()
    _run(d, rank, f"w{world}_{opt}_resumed", ckpt_dir=str(ckdir),
         ckpt_every=4, optimizer=opt)


def _refusals(d: Path, rank: int, world: int):
    """On W = 5: ``runner="protocol"`` at G = 4 leaves a rank without a
    place (refused on every rank), and the G' = 4 segment mesh's idle rank
    refuses a collective."""
    out = {}
    try:
        exp.run("elastic/static", runner="protocol", n_workers=4,
                n_servers=4, f_servers=0, device="cpu")
        out["protocol"] = None
    except ValueError as err:
        out["protocol"] = str(err)
    mesh = truns._segment_mesh(4)
    out["member"] = mesh.member
    try:
        mesh.all_gather(torch.zeros(1, 3), "rep", "probe")
        out["collective"] = None
    except RuntimeError as err:
        out["collective"] = str(err)
    with open(d / f"w{world}_refusals_{rank}.json", "w") as fh:
        json.dump(out, fh)


def _rank(rank: int, world: int, d: str):
    torch.set_num_threads(1)
    d = Path(d)
    tmesh.init_distributed("cpu", rank=rank, world=world,
                           init_method=f"file://{d}/store_{world}")
    try:
        _run(d, rank, f"w{world}_replay", replay=Replay(d))
        for opt in ("sgd", "adamw") if world == 8 else ("sgd",):
            _run(d, rank, f"w{world}_{opt}", optimizer=opt)
            _resume(d, rank, world, opt)
        if world == 5:
            _refusals(d, rank, world)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(d: Path):
    for world in (8, 5):
        t0 = time.perf_counter()
        mp.start_processes(_rank, args=(world, str(d)), nprocs=world,
                           start_method="spawn", join=True)
        print(f"[elastic-dist] {world} ranks: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    print("TORCH_ELASTIC_RUNNER_DONE", flush=True)


if __name__ == "__main__":
    main(Path(sys.argv[1]))

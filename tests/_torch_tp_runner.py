"""Subprocess body of ``tests/test_torch_tp.py``: the 'model' axis (tensor
parallelism) on gloo ranks on the CPU, spawned by ``torch.multiprocessing``
once. Imports no JAX: the parent hands in numpy inputs (``inputs.npz``) and
compares the results this writes beside them with JAX's single-device
protocol and serving.

    python tests/_torch_tp_runner.py <dir>

1. Reduced phi4-mini (f32), G = 4, T = 3, an ALIE worker, replayed quorum
   tables, on 8 ranks at (rep 4, fsdp 1, model 2), both engines: final
   params, every step's MDA weights, each rank's bytes sent per step by
   tag; a checkpoint of the final state saved and restored into the mesh.
2. The same on one card in this process (the single-card engine).
3. Quorum serving on the (4, 2) serve mesh on the same 8 ranks: an honest
   replica, and 4 replicas with replica 3 reversed; then ``launch.serve
   --mesh 4x2`` with its ZeRO threshold at 0 bytes (every leaf split over
   'data' too) against the same launcher on one rank.
4. Under ``torchrun --standalone``: ``launch.serve --mesh 1x4`` (the kv
   heads do not divide 4) and its single-rank run, ``launch.train --mesh
   4x2``, ``launch.serve --mesh 2x2`` and ``launch.train --arch
   qwen3-moe-235b-a22b --mesh 2x2`` (the MoE family, G = 2).
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.checkpoint import checkpointer as ck  # noqa: E402
from repro_torch.core import protocol as tproto  # noqa: E402
from repro_torch.core.attacks import ByzantineSpec  # noqa: E402
from repro_torch.core.quorum import TraceDelivery  # noqa: E402
from repro_torch.core.simulator import FlatTree  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models.registry import get_bundle  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.serve import QuorumService, ReplicaPool  # noqa: E402

G = 4
PROMPTS = [[3, 5, 7, 9], [11, 2, 4, 6]]
SERVE_B4 = ["--reduced", "--device", "cpu", "--batch", "4", "--prefill",
            "16", "--decode", "4"]


def _protocol(d: Path, engine: str, mesh):
    """Steps one at a time: (whole final params, MDA weights per step,
    this rank's bytes sent per step by tag, the final state)."""
    z = np.load(d / "inputs.npz")
    T = int(z["T"])
    bundle = get_bundle("phi4-mini-3.8b", reduced=True, act_dtype="float32")
    pcfg = tproto.ProtocolConfig.derive(
        G, T=T, engine=engine,
        byz=ByzantineSpec(worker_attack="alie", n_byz_workers=1))
    eng = tproto.ProtocolEngine(
        bundle, pcfg, tsched.inverse_linear(0.05, 0.05),
        delivery=TraceDelivery(z["pull"], z["push"], z["gather"], T=T,
                               device="cpu"),
        with_attack=True, device="cpu", mesh=mesh)
    toks = torch.from_numpy(z["tokens"]).long()
    batches = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    tree = FlatTree.from_params(bundle.init(torch.Generator()))
    state = tproto.ByzState(params=torch.from_numpy(z["params"]).clone(),
                            t=0, gen=torch.Generator().manual_seed(0),
                            tree=tree)
    state = tproto.shard_state(state, mesh,
                               tproto.model_split(bundle.cfg, tree, mesh))
    sel, qw = [], tproto.quorum_weights

    def record(*a):
        w = qw(*a)
        sel.append(w.numpy().copy())
        return w

    tproto.quorum_weights = record
    sent = []
    for i in range(toks.shape[0]):
        before = dict(mesh.sent) if mesh is not None else {}
        state, _ = eng.run(state, {k: v[i:i + 1] for k, v in batches.items()})
        after = dict(mesh.sent) if mesh is not None else {}
        sent.append({k: after[k] - before.get(k, 0) for k in after})
    tproto.quorum_weights = qw
    return tproto.whole_state(state).params.numpy(), np.stack(sel), sent, \
        state


def task_protocol(rank, d: Path):
    mesh = tmesh.make_protocol_mesh(G, model=2)
    for engine in ("sharded", "naive"):
        params, sel, sent, state = _protocol(d, engine, mesh)
        with open(d / f"tp_{engine}_sent_{rank}.json", "w") as fh:
            json.dump({"sent": sent, "mesh": mesh.sizes,
                       "P_m": state.split.local.size}, fh)
        if rank == 0:
            np.savez(d / f"tp_{engine}.npz", params=params, sel=sel)
    # a checkpoint of the (rep 4, model 2) state, restored into the mesh
    ckdir = str(d / "ck")
    ck.save(ckdir, state.t, state)
    like = tproto.ByzState(None, 0, None, tree=state.tree, mesh=mesh,
                           split=state.split)
    back, step = ck.restore(ckdir, state.t, like, "cpu")
    same = bool(torch.equal(back.params, state.params)) and step == state.t
    with open(d / f"ckpt_{rank}.json", "w") as fh:
        json.dump({"equal": same, "step": step}, fh)

    # quorum serving on the (4, 2) serve mesh, every rank
    smesh = tmesh.make_serve_mesh(tmesh.make_mesh((4, 2), ("data", "model")))
    bundle = get_bundle("phi4-mini-3.8b", reduced=True)
    rules = steps.serve_rules(smesh, bundle.cfg)
    params = bundle.init(torch.Generator().manual_seed(0))
    svc1 = QuorumService(ReplicaPool.from_params(params, 1, f=0), bundle,
                         n_slots=2, max_len=32, rules=rules)
    honest = svc1.generate(PROMPTS, max_new=5)
    pool4 = ReplicaPool.from_params(params, 4, f=1).corrupt(
        ByzantineSpec(server_attack="reversed", n_byz_servers=1),
        torch.Generator().manual_seed(7))
    svc4 = QuorumService(pool4, bundle, n_slots=2, max_len=32, rules=rules)
    outs = svc4.generate(PROMPTS, max_new=5)
    rep = svc4.report()
    blocks = svc4.pool.params["blocks"]["mlp"]["w_gate"].shape
    # ZeRO: every leaf also split over 'data', gathered at use
    zero, steps.ZERO_BYTES = steps.ZERO_BYTES, 0
    smesh.sent.clear()
    try:
        ids = serve.main(SERVE_B4 + ["--mesh", "4x2"])
    finally:
        steps.ZERO_BYTES = zero
    with open(d / f"serve_{rank}.json", "w") as fh:
        json.dump({"honest": honest, "quorum": outs,
                   "ejections": rep["ejections"], "mesh": smesh.sizes,
                   "w_gate": list(blocks), "zero_ids": ids.tolist()}, fh)


def _rank(rank: int, world: int, d: str):
    torch.set_num_threads(1)
    tmesh.init_distributed("cpu", rank=rank, world=world,
                           init_method=f"file://{d}/store_tp_{world}")
    try:
        task_protocol(rank, Path(d))
    finally:
        dist.destroy_process_group()


def _torchrun(n: int, args: list, env: dict):
    cmd = [sys.executable]
    if n > 1:
        cmd += ["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(n)]
    res = subprocess.run(cmd + args, env=env, capture_output=True,
                         text=True, timeout=300)
    return {"rc": res.returncode, "stdout": res.stdout,
            "stderr": res.stderr[-4000:]}


def _launchers(d: Path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    serve = ["-m", "repro_torch.launch.serve", "--reduced", "--device",
             "cpu", "--batch", "2", "--prefill", "16", "--decode", "4"]
    train = ["-m", "repro_torch.launch.train", "--reduced", "--device",
             "cpu", "--groups", "4", "--steps", "2", "--seq", "16",
             "--batch-per-group", "2", "--log-every", "1", "--T", "2"]
    t0 = time.perf_counter()
    out = {"serve_1x4": _torchrun(4, serve + ["--mesh", "1x4"], env),
           "serve_1x1": _torchrun(1, serve, env),
           "train_4x2": _torchrun(8, train + ["--mesh", "4x2"], env),
           "serve_2x2": _torchrun(4, serve + ["--mesh", "2x2"], env),
           "moe_2x2": _torchrun(4, train[:5] + ["--groups", "2"] + train[7:]
                                + ["--arch", "qwen3-moe-235b-a22b",
                                   "--mesh", "2x2"], env)}
    with open(d / "launch.json", "w") as fh:
        json.dump(out, fh)
    print(f"[tp] launchers: {time.perf_counter() - t0:.1f} s", flush=True)


def main(d: Path):
    torch.set_num_threads(1)
    for engine in ("sharded", "naive"):
        params, sel, _, _ = _protocol(d, engine, None)
        np.savez(d / f"single_{engine}.npz", params=params, sel=sel)
    with open(d / "serve_b4.json", "w") as fh:
        json.dump(serve.main(SERVE_B4).tolist(), fh)
    t0 = time.perf_counter()
    mp.start_processes(_rank, args=(8, str(d)), nprocs=8,
                       start_method="spawn", join=True)
    print(f"[tp] 8 ranks: {time.perf_counter() - t0:.1f} s", flush=True)
    _launchers(d)
    print("TORCH_TP_RUNNER_DONE", flush=True)


if __name__ == "__main__":
    main(Path(sys.argv[1]))

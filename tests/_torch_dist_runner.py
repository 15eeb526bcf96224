"""Subprocess body of ``tests/test_torch_dist.py``: the port's protocol on
gloo ranks on the CPU, spawned by ``torch.multiprocessing``. Imports no JAX:
the parent hands in numpy inputs (``inputs.npz``) and compares the results
this writes beside them with JAX's single-device protocol.

    python tests/_torch_dist_runner.py <dir>

1. ``tfm_tiny`` (f32) on 8 ranks, mesh (rep 4, fsdp 2), both engines, an
   ALIE worker, replayed quorum tables: final params, every step's MDA
   weights and each rank's bytes sent per step, by tag; and on batches of
   3 rows a group, which the 'fsdp' ranks split unevenly.
2. The same at (rep 4, fsdp 1) on 4 ranks, and on one card in this
   process.
3. ``serve/ckpt_smoke`` on 5 ranks (rep 5): the checkpoint restored by
   ``ReplicaPool.from_checkpoint`` against the whole final state.
4. ``launch.train --mesh 4x1`` under ``torchrun --standalone`` (2 steps),
   and ``--arch qwen3-moe-235b-a22b --reduced --mesh 4x2`` on one
   process, which is refused (the MoE takes the 'model' axis, but one
   rank cannot fill the 8 of the mesh).
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

from repro_torch import exp  # noqa: E402
from repro_torch.core import protocol as tproto  # noqa: E402
from repro_torch.core.attacks import ByzantineSpec  # noqa: E402
from repro_torch.core.quorum import TraceDelivery  # noqa: E402
from repro_torch.core.simulator import FlatTree  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.registry import get_bundle  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402

G = 4


def _setup(d: Path, engine: str, tokens: str = "tokens"):
    """(bundle, protocol config, delivery, batches, whole initial state)
    from the parent's inputs."""
    z = np.load(d / "inputs.npz")
    T = int(z["T"])
    bundle = get_bundle("phi4-mini-3.8b", reduced=True, act_dtype="float32")
    pcfg = tproto.ProtocolConfig.derive(
        G, T=T, engine=engine,
        byz=ByzantineSpec(worker_attack="alie", n_byz_workers=1))
    delivery = TraceDelivery(z["pull"], z["push"], z["gather"], T=T,
                             device="cpu")
    toks = torch.from_numpy(z[tokens]).long()
    batches = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    tree = FlatTree.from_params(bundle.init(torch.Generator()))
    state = tproto.ByzState(params=torch.from_numpy(z["params"]).clone(),
                            t=0, gen=torch.Generator().manual_seed(0),
                            tree=tree)
    return bundle, pcfg, delivery, batches, state


def _protocol(d: Path, engine: str, mesh, tokens: str = "tokens"):
    """Steps one at a time on ``mesh``: (whole final params, MDA weights
    per step, this rank's bytes sent per step by tag)."""
    bundle, pcfg, delivery, batches, state = _setup(d, engine, tokens)
    eng = tproto.ProtocolEngine(bundle, pcfg, tsched.inverse_linear(0.05, 0.05),
                                delivery=delivery, with_attack=True,
                                device="cpu", mesh=mesh)
    sel, qw = [], tproto.quorum_weights

    def record(*a):
        w = qw(*a)
        sel.append(w.numpy().copy())
        return w

    tproto.quorum_weights = record
    state = tproto.shard_state(state, mesh)
    sent = []
    steps = batches["tokens"].shape[0]
    for i in range(steps):
        before = dict(mesh.sent) if mesh is not None else {}
        state, _ = eng.run(state, {k: v[i:i + 1] for k, v in batches.items()})
        after = dict(mesh.sent) if mesh is not None else {}
        sent.append({k: after[k] - before.get(k, 0) for k in after})
    tproto.quorum_weights = qw
    whole = tproto.whole_state(state)
    return whole.params.numpy(), np.stack(sel), sent


def task_protocol(rank, world, d: Path):
    mesh = tmesh.make_protocol_mesh(G)
    for engine in ("sharded", "naive") if world == 8 else ("sharded",):
        params, sel, sent = _protocol(d, engine, mesh)
        tag = f"w{world}_{engine}"
        with open(d / f"{tag}_sent_{rank}.json", "w") as fh:
            json.dump({"sent": sent, "mesh": mesh.sizes,
                       "layout": tproto.state_layout(mesh, G, params.shape[1])
                       ._asdict()}, fh)
        if rank == 0:
            np.savez(d / f"{tag}.npz", params=params, sel=sel)
    if world == 8:
        # 3 rows a group: the 'fsdp' ranks' parts are 1 and 2 rows
        params, sel, _ = _protocol(d, "sharded", mesh, "tokens3")
        if rank == 0:
            np.savez(d / "w8_uneven.npz", params=params, sel=sel)


def task_ckpt(rank, world, d: Path):
    from repro_torch.checkpoint import checkpointer as ck
    from repro_torch.serve import ReplicaPool
    ckdir = d / "ck"
    res = exp.run("serve/ckpt_smoke", ckpt_dir=str(ckdir), device="cpu")
    whole = tproto.whole_state(res.state)
    if rank == 0:
        e = exp.get("serve/ckpt_smoke")
        pool = ReplicaPool.from_checkpoint(str(ckdir), e.build_problem()[0],
                                           f=1, device="cpu")
        got = whole.tree.leaves(pool.params)
        want = whole.tree.leaves(whole.tree.unflatten(whole.params))
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        with open(d / "ckpt.json", "w") as fh:
            json.dump({"mesh": res.provenance["mesh"],
                       "latest": ck.latest_step(str(ckdir)),
                       "steps": e.steps, "n_replicas": pool.n_replicas,
                       "equal": bool(equal), "acc": res.final["acc"]}, fh)


TASKS = {"protocol": task_protocol, "ckpt": task_ckpt}


def _rank(rank: int, world: int, task: str, d: str):
    torch.set_num_threads(1)
    tmesh.init_distributed("cpu", rank=rank, world=world,
                           init_method=f"file://{d}/store_{task}_{world}")
    try:
        TASKS[task](rank, world, Path(d))
    finally:
        dist.destroy_process_group()


def _spawn(task: str, world: int, d: Path):
    t0 = time.perf_counter()
    mp.start_processes(_rank, args=(world, task, str(d)), nprocs=world,
                       start_method="spawn", join=True)
    print(f"[dist] {task} on {world} ranks: {time.perf_counter() - t0:.1f} s",
          flush=True)


def _launcher(d: Path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    args = ["-m", "repro_torch.launch.train", "--reduced", "--device", "cpu",
            "--groups", "4", "--steps", "2", "--seq", "16",
            "--batch-per-group", "2", "--log-every", "1", "--T", "2"]
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4"] + args + ["--mesh", "4x1"],
        env=env, capture_output=True, text=True, timeout=300)
    refused = subprocess.run([sys.executable] + args + [
        "--arch", "qwen3-moe-235b-a22b", "--mesh", "4x2"],
                             env=env, capture_output=True, text=True,
                             timeout=300)
    with open(d / "launch.json", "w") as fh:
        json.dump({"rc": run.returncode, "stdout": run.stdout,
                   "stderr": run.stderr[-4000:],
                   "refused_rc": refused.returncode,
                   "refused_stderr": refused.stderr[-2000:]}, fh)
    print(f"[dist] launch.train under torchrun: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def main(d: Path):
    torch.set_num_threads(1)
    for tokens, name in (("tokens", "single"), ("tokens3", "single3")):
        params, sel, _ = _protocol(d, "sharded", None, tokens)
        np.savez(d / f"{name}.npz", params=params, sel=sel)
    _spawn("protocol", 8, d)
    _spawn("protocol", 4, d)
    _spawn("ckpt", 5, d)
    _launcher(d)
    print("TORCH_DIST_RUNNER_DONE", flush=True)


if __name__ == "__main__":
    main(Path(sys.argv[1]))

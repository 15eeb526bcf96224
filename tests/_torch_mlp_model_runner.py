"""Subprocess body of ``tests/test_torch_mlp_model.py``: the paper's MLP
on a mesh with a 'model' axis, over gloo ranks on the CPU, spawned by
``torch.multiprocessing`` once (4 ranks). Imports no JAX: the parent hands
in numpy inputs (``inputs.npz``) and compares what this writes beside them
with JAX's one-device protocol and ``jax.grad``.

    python tests/_torch_mlp_model_runner.py <dir>

1. In this process, the port's one-rank protocol runs (no mesh) of every
   run of ``RUNS``: final params, every step's MDA weights, the accuracy
   buffer.
2. On each of the 4 ranks:
   a. the split form's loss and gradients of each case of the parent's
      (``case{i}_*``) on the 'model' line of the (2, 1, 2) mesh: the loss,
      the rank's gradient blocks and its bytes sent by tag;
   b. each run of ``RUNS`` on its mesh, (rep 2, fsdp 1, model 2) or (rep 1,
      fsdp 2, model 2), from the parent's initial stack, one step at a time:
      the whole final params, every step's MDA weights, the rank's bytes
      sent on each step by tag, the accuracy buffer, the rank's final
      block and its columns;
   c. after the first run at (2, 1, 2): a checkpoint of the final state,
      restored on one rank (no mesh) and into the mesh, and
      ``consolidate`` on the mesh beside the one-card median of the whole
      stack.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.checkpoint import checkpointer as ck  # noqa: E402
from repro_torch.configs import paper_models as tmodels  # noqa: E402
from repro_torch.core import protocol as tproto  # noqa: E402
from repro_torch.core.attacks import ByzantineSpec  # noqa: E402
from repro_torch.core.quorum import TraceDelivery  # noqa: E402
from repro_torch.core.simulator import FlatTree  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import sharding as shr  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402

WORLD = 4
#: (mesh, engine, pull) of each protocol run; a mesh is (rep, fsdp, model)
RUNS = [((2, 1, 2), "sharded", "median"), ((2, 1, 2), "naive", "median"),
        ((1, 2, 2), "sharded", "median"), ((1, 2, 2), "naive", "median"),
        ((2, 1, 2), "naive", "roundrobin"),
        ((1, 2, 2), "sharded", "roundrobin")]


def run_name(shape, engine, pull) -> str:
    return f"{''.join(map(str, shape))}_{engine}_{pull}"


class Inputs:
    """The parent's problem, protocol config and inputs."""

    def __init__(self, d: Path):
        z = np.load(d / "inputs.npz")
        self.z = z
        self.dim, self.hidden, self.classes, self.depth = (
            int(v) for v in z["mlp"])
        self.G, self.T, self.lr = int(z["G"]), int(z["T"]), tuple(z["lr"])
        self.tables = (z["pull"], z["push"], z["gather"])
        self.x, self.y = torch.from_numpy(z["x"]), torch.from_numpy(z["y"])
        self.eval_set = (torch.from_numpy(z["ex"]), torch.from_numpy(z["ey"]))
        self.params0 = torch.from_numpy(z["params0"])

    def problem(self):
        init, loss, acc = tmodels.make_mlp_problem(
            self.dim, self.hidden, self.classes, self.depth)
        return tproto.ProblemBundle(init=init, loss=loss), acc

    def pcfg(self, engine: str, pull: str) -> tproto.ProtocolConfig:
        return tproto.ProtocolConfig.derive(
            self.G, T=self.T, engine=engine, pull=pull,
            byz=ByzantineSpec(worker_attack="alie", n_byz_workers=1))


def protocol_run(inp: Inputs, engine: str, pull: str, mesh):
    """One run, a step at a time: (final state, MDA weights per step,
    bytes sent on each step by tag, accuracy per step)."""
    bundle, acc = inp.problem()
    pcfg = inp.pcfg(engine, pull)
    eng = tproto.ProtocolEngine(
        bundle, pcfg, tsched.inverse_linear(*inp.lr),
        delivery=TraceDelivery(*inp.tables, T=inp.T, device="cpu"),
        with_attack=True, acc_fn=acc, eval_set=inp.eval_set, device="cpu",
        mesh=mesh)
    tree = FlatTree.from_params(bundle.init(torch.Generator()))
    state = tproto.ByzState(params=inp.params0.clone(), t=0,
                            gen=torch.Generator().manual_seed(0), tree=tree)
    state = tproto.shard_state(state, mesh,
                               tproto.model_split(bundle.cfg, tree, mesh))
    sel, qw = [], tproto.quorum_weights

    def record(*a):
        w = qw(*a)
        sel.append(w.numpy().copy())
        return w

    tproto.quorum_weights = record
    sent, accs = [], []
    try:
        for i in range(inp.x.shape[0]):
            before = dict(mesh.sent) if mesh is not None else {}
            state, m = eng.run(state, (inp.x[i:i + 1], inp.y[i:i + 1].long()))
            accs.append(float(m["acc"][0]))
            after = dict(mesh.sent) if mesh is not None else {}
            sent.append({k: after[k] - before.get(k, 0) for k in after})
    finally:
        tproto.quorum_weights = qw
    return state, np.stack(sel), sent, accs


def loss_cases(inp: Inputs, d: Path, rank: int, mesh) -> None:
    """The split form's loss and gradients of each of the parent's cases
    on this rank's 'model' line."""
    z = inp.z
    out, sent = {}, []
    for c in range(int(z["n_cases"])):
        dim, hidden, classes, depth = (int(v) for v in z[f"case{c}_mlp"])
        _, loss, _ = tmodels.make_mlp_problem(dim, hidden, classes, depth)
        names = [f"{k}{i}" for k in "bw" for i in range(depth + 1)]
        whole = {k: torch.from_numpy(z[f"case{c}_{k}"]) for k in names}
        tree = FlatTree.from_params(whole)
        split = tproto.model_split(tproto._ProblemCfg(), tree, mesh)
        leaves = [split.block(v, i).clone().requires_grad_()
                  for i, v in enumerate(tree.leaves(whole))]
        batch = (torch.from_numpy(z[f"case{c}_x"]),
                 torch.from_numpy(z[f"case{c}_y"]).long())
        before = dict(mesh.sent)
        with shr.sharding_rules(tmodels.mlp_rules(split, mesh)):
            val = loss(tproto._rebuild(tree, leaves), batch)
            grads = torch.autograd.grad(val, leaves)
        sent.append({k: v - before.get(k, 0) for k, v in mesh.sent.items()})
        out[f"case{c}_loss"] = val.detach().numpy()
        for path, g in zip(tree.paths, grads):
            out[f"case{c}_{path[0]}"] = g.numpy()
        out[f"case{c}_dims"] = np.asarray(
            [-1 if v is None else v for v in split.dims])
    np.savez(d / f"cases_{rank}.npz", **out)
    with open(d / f"cases_{rank}.json", "w") as fh:
        json.dump(sent, fh)


def checkpoint_and_consolidate(inp: Inputs, d: Path, rank: int, state,
                               pcfg) -> dict:
    """A save of the mesh state restored on one rank and into the mesh,
    and ``consolidate`` on the mesh against the one-card median."""
    whole = tproto.whole_state(state).params
    ckdir = str(d / "ck")
    ck.save(ckdir, state.t, state)
    dist.barrier()
    one, step = ck.restore(ckdir, state.t, tproto.ByzState(
        None, 0, None, tree=state.tree), "cpu")
    back, _ = ck.restore(ckdir, state.t, tproto.ByzState(
        None, 0, None, tree=state.tree, mesh=state.mesh, split=state.split),
        "cpu")
    median = tproto.consolidate(whole)
    on_mesh = tproto.consolidate(state.params, pcfg, mesh=state.mesh,
                                 n_params=state.tree.size, split=state.split)
    blocks = tproto.consolidate(state.params, pcfg, mesh=state.mesh,
                                n_params=state.tree.size, split=state.split,
                                blocks=True)
    return {"step": step, "t": state.t,
            "one_rank": bool(torch.equal(one.params, whole)),
            "into_mesh": bool(torch.equal(back.params, state.params)),
            "consolidate": bool(torch.equal(on_mesh, median)),
            "consolidate_blocks": bool(torch.equal(
                blocks, state.split.cut(median)))}


def task(rank: int, d: Path) -> None:
    inp = Inputs(d)
    base = tmesh.make_mesh((2, 2), ("data", "model"))
    meshes = {(2, 1, 2): tmesh.make_byz_mesh(base, 2),
              (1, 2, 2): tmesh.make_byz_mesh(base, 1)}
    loss_cases(inp, d, rank, meshes[(2, 1, 2)])
    rec = {}
    for shape, engine, pull in RUNS:
        mesh = meshes[shape]
        assert mesh.shape == shape, (mesh.shape, shape)
        state, sel, sent, accs = protocol_run(inp, engine, pull, mesh)
        name = run_name(shape, engine, pull)
        ranks = tproto._Ranks(mesh, inp.G, state.tree.size,
                              tproto.ProtocolConfig.chunk_bytes, state.split)
        rec[name] = {"sent": sent, "acc": accs, "P_m": state.split.local.size,
                     "cols": [ranks.k0, ranks.k1], "rows": [ranks.r0,
                                                            ranks.r1],
                     "coords": list(mesh.coords)}
        whole = tproto.whole_state(state).params.numpy()
        np.savez(d / f"{name}_{rank}.npz", params=whole, sel=sel,
                 block=state.params.numpy())
        if name == run_name((2, 1, 2), "sharded", "median"):
            rec["checkpoint"] = checkpoint_and_consolidate(
                inp, d, rank, state, inp.pcfg(engine, pull))
    with open(d / f"ranks_{rank}.json", "w") as fh:
        json.dump(rec, fh)


def _rank(rank: int, world: int, d: str):
    torch.set_num_threads(1)
    tmesh.init_distributed("cpu", rank=rank, world=world,
                           init_method=f"file://{d}/store_mlp_model")
    try:
        task(rank, Path(d))
    finally:
        dist.destroy_process_group()


def main(d: Path):
    torch.set_num_threads(1)
    inp = Inputs(d)
    for _, engine, pull in RUNS:
        state, sel, _, accs = protocol_run(inp, engine, pull, None)
        np.savez(d / f"one_{engine}_{pull}.npz", params=state.params.numpy(),
                 sel=sel, acc=np.asarray(accs))
    mp.start_processes(_rank, args=(WORLD, str(d)), nprocs=WORLD,
                       start_method="spawn", join=True)
    print("TORCH_MLP_MODEL_RUNNER_DONE", flush=True)


if __name__ == "__main__":
    main(Path(sys.argv[1]))

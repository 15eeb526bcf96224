"""Subprocess body of ``tests/test_torch_tp_zoo.py``: the 'model' axis
(tensor parallelism) for the MoE, hybrid, RWKV6 and audio families on gloo
ranks on the CPU, spawned by ``torch.multiprocessing`` once. Imports no
JAX: the parent hands in numpy inputs (``<arch>.npz``) and compares the
results this writes beside them with JAX's single-device protocol.

    python tests/_torch_tp_zoo_runner.py <dir> <arch> [<arch> ...]

On 4 ranks at (rep 2, fsdp 1, model 2), G = 4:

1. each arch's reduced model (f32) through ``ProtocolEngine`` with an
   ALIE worker and replayed quorum tables, one step at a time: final
   params, every step's MDA weights, each rank's bytes sent per step by
   tag; a checkpoint of the final state saved and restored into the mesh;
2. on the (2, 2) serve mesh, each arch's reduced model (f32 weights,
   activations and caches) prefilled and decoded greedily, split over
   'model', against the same run whole on one rank: the logits of every
   step and the tokens;
3. ``QuorumService`` on that mesh for the token-in families (MoE, RWKV6,
   zamba2): an honest replica, and 4 replicas with replica 3 reversed
   (bf16); an honest replica in f32, on the mesh and whole on one rank.
"""
import json
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
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import sharding as shr  # noqa: E402
from repro_torch.models.registry import get_bundle  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.serve import QuorumService, ReplicaPool  # noqa: E402

G = 4
DECODE = 3                            # decode steps of the split check
PROMPTS = [[3, 5, 7, 9], [11, 2, 4, 6]]
#: the reduced configs' overrides, the same in the parent
OVERRIDES = {"qwen3-moe-235b-a22b": dict(n_layers=1),
             "rwkv6-3b": dict(n_layers=1),
             "zamba2-1.2b": dict(n_layers=2),
             "whisper-small": dict(n_layers=1, encoder_layers=1)}


def bundle_of(arch: str, act: str = "float32"):
    return get_bundle(arch, reduced=True, act_dtype=act,
                      param_dtype="float32", **OVERRIDES[arch])


def _protocol(d: Path, arch: str, mesh):
    """Steps one at a time: (whole final params, MDA weights per step,
    this rank's bytes sent per step by tag, the final state)."""
    z = np.load(d / f"{arch}.npz")
    T = int(z["T"])
    bundle = bundle_of(arch)
    pcfg = tproto.ProtocolConfig.derive(
        G, T=T, byz=ByzantineSpec(worker_attack="alie", n_byz_workers=1))
    eng = tproto.ProtocolEngine(
        bundle, pcfg, tsched.inverse_linear(0.05, 0.05),
        delivery=TraceDelivery(z["pull"], z["push"], z["gather"], T=T,
                               device="cpu"),
        with_attack=True, device="cpu", mesh=mesh)
    batches = {k[2:]: torch.from_numpy(z[k]) for k in z.files
               if k.startswith("b_")}
    batches = {k: v.long() if k != "enc_frames" else v
               for k, v in batches.items()}
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
    try:
        for i in range(batches["labels"].shape[0]):
            before = dict(mesh.sent)
            state, _ = eng.run(state, {k: v[i:i + 1]
                                       for k, v in batches.items()})
            sent.append({k: v - before.get(k, 0)
                         for k, v in mesh.sent.items()})
    finally:
        tproto.quorum_weights = qw
    return (tproto.whole_state(state).params.numpy(), np.stack(sel), sent,
            state)


def _checkpoint(d: Path, arch: str, state, mesh) -> dict:
    """A save of the (rep 2, model 2) state, restored into the mesh."""
    ckdir = str(d / f"ck_{arch}")
    ck.save(ckdir, state.t, state)
    like = tproto.ByzState(None, 0, None, tree=state.tree, mesh=mesh,
                           split=state.split)
    back, step = ck.restore(ckdir, state.t, like, "cpu")
    return {"equal": bool(torch.equal(back.params, state.params)),
            "step": step}


def _decode(arch: str, smesh, split: bool):
    """The reduced model (f32 weights, activations and caches) prefilled on
    this rank's 'data' rows of a 2 x 8 batch and decoded ``DECODE`` steps
    greedily: split over ``smesh``'s 'model' ranks, or whole on this rank
    (``split`` false: no rules, no collective). Returns the logits of
    every step ``[DECODE + 1, B, V]``, joined over the vocab, and the
    tokens ``[B, DECODE + 1]``."""
    bundle = bundle_of(arch)
    params = bundle.init(torch.Generator().manual_seed(0))
    pf = bundle.make_batch("prefill", 2, 8, torch.Generator().manual_seed(1))
    pf = {k: steps.block(v, steps.batch_sharding(k, v.shape, smesh), smesh)
          for k, v in pf.items()}
    rules, M = None, 1
    if split:
        params = tserve._cut_params(params, smesh, bundle.cfg)
        rules, M = steps.serve_rules(smesh, bundle.cfg), smesh.size("model")
    B = next(v for k, v in pf.items() if k != "positions").shape[0]
    with torch.inference_mode(), shr.sharding_rules(rules):
        caches = bundle.init_caches(B, max_len=16, n_chunks=M,
                                    dtype=torch.float32)
        logits, caches = bundle.prefill(params, pf, caches)
        outs, toks = [L.gather_vocab(logits)], [L.argmax_vocab(logits)]
        for i in range(DECODE):
            logits, caches = bundle.decode(
                params, caches,
                tserve.decode_batch(bundle, pf, toks[-1][:, None], i))
            outs.append(L.gather_vocab(logits))
            toks.append(L.argmax_vocab(logits))
    return torch.stack(outs).float(), torch.stack(toks, 1)


def _split_decode(arch: str, smesh) -> dict:
    """:func:`_decode` split against whole, on this rank's rows: every
    step's rel-L2 of the logits, and whether the tokens are equal."""
    got, tok = _decode(arch, smesh, True)
    want, wtok = _decode(arch, smesh, False)
    rel = [((a - b).norm() / b.norm()).item() for a, b in zip(got, want)]
    return {"rel_l2": rel, "tokens_equal": bool(torch.equal(tok, wtok)),
            "rows": tok.shape[0]}


def _serve(arch: str, smesh):
    """The honest replica's tokens and the 4-replica pool's (replica 3
    reversed) on the serve mesh, bf16, with the pool's ejections; and
    the honest replica's tokens in f32 on the mesh and whole on this rank
    (no rules)."""
    bundle = bundle_of(arch, "bfloat16")
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
    f32 = bundle_of(arch)
    p32 = f32.init(torch.Generator().manual_seed(0))

    def one(rules):
        return QuorumService(ReplicaPool.from_params(p32, 1, f=0), f32,
                             n_slots=2, max_len=32, rules=rules).generate(
                                 PROMPTS, max_new=5)

    return {"honest": honest, "quorum": outs,
            "ejections": svc4.report()["ejections"],
            "f32_mesh": one(rules), "f32_single": one(None)}


def task(rank: int, d: Path, archs: list):
    mesh = tmesh.make_protocol_mesh(G, model=2)
    for arch in archs:
        t0 = time.perf_counter()
        params, sel, sent, state = _protocol(d, arch, mesh)
        with open(d / f"{arch}_sent_{rank}.json", "w") as fh:
            json.dump({"sent": sent, "mesh": mesh.sizes,
                       "P_m": state.split.local.size,
                       "ckpt": _checkpoint(d, arch, state, mesh)}, fh)
        if rank == 0:
            np.savez(d / f"{arch}_tp.npz", params=params, sel=sel)
            print(f"[tp-zoo] {arch}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    smesh = tmesh.make_serve_mesh(tmesh.make_mesh((2, 2), ("data", "model")))
    out = {"mesh": smesh.sizes}
    for arch in archs:
        t0 = time.perf_counter()
        out[arch] = {"decode": _split_decode(arch, smesh)}
        if arch != "whisper-small":
            out[arch].update(_serve(arch, smesh))
        if rank == 0:
            print(f"[tp-zoo] {arch} serving: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    with open(d / f"serve_{rank}.json", "w") as fh:
        json.dump(out, fh)


def _rank(rank: int, world: int, d: str, archs: list):
    torch.set_num_threads(1)
    tmesh.init_distributed("cpu", rank=rank, world=world,
                           init_method=f"file://{d}/store_tp_zoo")
    try:
        task(rank, Path(d), archs)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(d: Path, archs: list):
    t0 = time.perf_counter()
    mp.start_processes(_rank, args=(4, str(d), archs), nprocs=4,
                       start_method="spawn", join=True)
    print(f"[tp-zoo] 4 ranks: {time.perf_counter() - t0:.1f} s", flush=True)
    print("TORCH_TP_ZOO_RUNNER_DONE", flush=True)


if __name__ == "__main__":
    main(Path(sys.argv[1]), sys.argv[2:])

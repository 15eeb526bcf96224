"""End-to-end ByzSGD training launcher (port of ``repro.launch.train``): the
distributed protocol, its G groups co-located on one card or spread over
``torch.distributed`` ranks, Byzantine attack injection, the DMC cadence
and loss logging.

  python -m repro_torch.launch.train --arch phi4-mini-3.8b --depth 2 \\
      --groups 4 --T 5 --seq 1024 --batch-per-group 4 --steps 11 \\
      --worker-attack alie --n-byz 1
  # the RWKV6 family (or --arch qwen3-moe-235b-a22b for the MoE)
  python -m repro_torch.launch.train --arch rwkv6-3b --depth 2 --groups 4
  # CPU smoke of a reduced arch, checkpointed every 5 steps; run it again
  # with a larger --steps to resume from the latest checkpoint
  python -m repro_torch.launch.train --reduced --device cpu --steps 7 \\
      --groups 4 --seq 32 --batch-per-group 2 --log-every 1 \\
      --ckpt-dir /tmp/ck --ckpt-every 5
  # four ranks (rep 4), one group each, on the CPU over gloo
  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
      --reduced --device cpu --mesh 4x1 --groups 4 --steps 2
  # eight ranks: rep 4 x model 2 (tensor parallelism inside each group)
  torchrun --standalone --nproc-per-node 8 -m repro_torch.launch.train \\
      --reduced --device cpu --mesh 4x2 --groups 4 --steps 2
  # the MoE family at rep 2 x model 2
  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen3-moe-235b-a22b --reduced --device cpu --mesh 2x2 \\
      --groups 2 --steps 2

``--arch`` takes every arch of the reference (``models.registry.ARCH_IDS``)
and the port's own (``PORT_ONLY_IDS``: granite-4.0-h-micro, whose family
takes no 'model' axis) and feeds it the token stream; whisper-small (the audio family), whose
loss reads encoder frames a token stream does not carry, is refused up
front (the JAX launcher fails with a ``KeyError`` at its first step).
Runs on the GPU; ``--device cpu`` is for smoke runs. ``--mesh DxM`` names
the ('data', 'model') base mesh as the reference's launcher does: D x M
ranks (``torchrun --nproc-per-node D*M``; by default the world's size
x 1), carved by ``make_byz_mesh`` into G = ``--groups`` (default D) 'rep'
groups of D / G 'fsdp' slices of M 'model' ranks. M > 1 runs tensor
parallelism inside each group, for every family the launcher trains
(the dense, vlm, MoE, hybrid and RWKV6 families). Where G does not
divide D (M = 1), the ranks hold G / D groups each
(``make_protocol_mesh``), and on one rank the G groups share its device
(the reference needs G devices). Rank 0 alone prints and writes the
checkpoints; every rank takes part in their gathers. A run that joined a
process group leaves it on every exit
(:func:`~repro_torch.launch.mesh.leaving_group`). ``TrainRun.sent``
holds the bytes this rank sent in each step, by tag.
``--depth`` keeps the arch's width and cuts its depth (``get_bundle(...,
depth=...)``). With ``--ckpt-dir`` the run resumes from the latest
checkpoint there (params, step counter and the run's generator; the token
stream skips the steps done) and saves every ``--ckpt-every`` steps and at
the end, each labelled by the steps done (the JAX launcher labels a save
after step i with i, one step late).
``--trace PATH`` profiles the run's last DMC period (its last T steps)
under ``torch.profiler`` on rank 0 and writes a Chrome trace to PATH
(open it in Perfetto or ``chrome://tracing``): the device's kernels beside
the step's spans (``byzsgd.step``, ``byzsgd.pull``, ``byzsgd.grads`` with
``byzsgd.model`` and ``byzsgd.flatten`` per group, ``byzsgd.attack``,
``byzsgd.select``, ``byzsgd.aggregate``, ``byzsgd.update``,
``byzsgd.gather``, the scans' ``rwkv6.wkv`` / ``mamba2.ssd``, and the
``byzsgd.host_sync`` marks; :mod:`repro_torch.spans`).

  python -m repro_torch.launch.train --reduced --device cpu --steps 4 \\
      --groups 4 --seq 32 --batch-per-group 2 --T 2 --trace /tmp/step.json
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Any

import torch

from .. import device as devmod
from ..checkpoint import checkpointer as ck
from ..core import protocol
from ..core.attacks import ByzantineSpec
from ..data.pipeline import DeviceTokenStream, TokenSpec
from ..models.registry import ALL_IDS, get_bundle
from ..models.sharding import sharding_rules
from ..optim.schedules import inverse_linear
from .mesh import (launch_mesh, leaving_group, make_byz_mesh, make_mesh,
                   make_protocol_mesh)
from .steps import train_rules


@dataclass
class TrainRun:
    """What a :func:`main` run leaves: the logged ``(step, loss)`` pairs,
    wall seconds per step, the final state and the step function (a caller
    may take more steps)."""
    losses: list = field(default_factory=list)
    step_s: list = field(default_factory=list)
    sent: list = field(default_factory=list)
    n_params: int = 0
    state: Any = None
    step: Any = None
    bundle: Any = None


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b", choices=ALL_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--depth", type=int, default=None,
                    help="override n_layers (the width stays)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--groups", type=int, default=None)
    ap.add_argument("--mesh", default=None,
                    help="DxM data x model ranks; default Wx1")
    ap.add_argument("--batch-per-group", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--T", type=int, default=10)
    ap.add_argument("--engine", default="sharded")
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--worker-attack", default=None)
    ap.add_argument("--server-attack", default=None)
    ap.add_argument("--n-byz", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without a GPU)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace of the last T steps to PATH")
    return ap


def protocol_config(G: int, T: int, engine: str = "sharded",
                    byz: ByzantineSpec | None = None
                    ) -> protocol.ProtocolConfig:
    """The launcher's protocol for G groups: the largest tolerated f_w =
    (G - 1) // 3 and f_ps = (G - 2) // 3, quorums of G - f."""
    f_w, f_ps = max((G - 1) // 3, 0), max((G - 2) // 3, 0)
    return protocol.ProtocolConfig(
        n_groups=G, f_workers=f_w, f_servers=f_ps, q_workers=G - f_w,
        q_servers=max(G - f_ps, min(2 * f_ps + 2, G)), T=T, engine=engine,
        byz=byz or ByzantineSpec())


def _mesh(args, cfg):
    """(this rank's device, the protocol mesh, G) of ``--mesh`` /
    ``--groups`` over the ranks ``torchrun`` started."""
    dev, d, m = launch_mesh(args.mesh, args.device, cfg)
    G = args.groups or d
    if d % G:
        if m > 1:
            raise SystemExit(f"--mesh {d}x{m}: G={G} groups must divide "
                             f"D={d} with a 'model' axis")
        # more groups than ranks: G / D groups a rank (all G on one rank)
        return dev, make_protocol_mesh(G), G
    return dev, make_byz_mesh(make_mesh((d, m), ("data", "model")), G), G


def main(argv=None) -> TrainRun:
    args = parser().parse_args(argv)
    bundle = get_bundle(args.arch, reduced=args.reduced, depth=args.depth)
    if bundle.cfg.family == "audio":
        raise ValueError(f"{args.arch}: its loss reads batch['enc_frames'] "
                         "(encoder frames), which the launcher's token "
                         "stream does not carry; train it through "
                         "ProtocolEngine.run with frame batches")
    with leaving_group():
        return _train(args, bundle)


def _train(args, bundle) -> TrainRun:
    dev, mesh, G = _mesh(args, bundle.cfg)
    lead = mesh.rank == 0
    byz = ByzantineSpec(worker_attack=args.worker_attack,
                        server_attack=args.server_attack,
                        n_byz_workers=args.n_byz if args.worker_attack else 0,
                        n_byz_servers=args.n_byz if args.server_attack else 0)
    pcfg = protocol_config(G, args.T, args.engine, byz)
    f_w, f_ps = pcfg.f_workers, pcfg.f_servers

    t0 = time.perf_counter()
    latest = ck.latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if latest is None:
        state = protocol.make_init_fn(bundle, pcfg, dev, mesh)(0)
    else:
        # the params tree comes from the manifest, so no second model is
        # initialized only to be overwritten
        tree = protocol.tree_from_manifest(
            ck.read_manifest(args.ckpt_dir, latest)["leaves"])
        state, _ = ck.restore(args.ckpt_dir, latest, protocol.ByzState(
            None, 0, None, tree=tree, mesh=mesh,
            split=protocol.model_split(bundle.cfg, tree, mesh)), dev)
        if lead:
            print(f"[train] restored checkpoint at step {state.t} from "
                  f"{args.ckpt_dir}")
    start = state.t
    step = protocol.make_train_step(
        bundle, pcfg, inverse_linear(args.lr, 0.005),
        with_attack=bool(args.worker_attack or args.server_attack),
        mesh=mesh)
    devmod.synchronize(dev)
    run = TrainRun(n_params=state.tree.size, step=step, bundle=bundle)
    if lead:
        print(f"[train] {bundle.cfg.name}: {bundle.cfg.n_layers} layers, "
              f"d_model {bundle.cfg.d_model}, {run.n_params / 1e6:.1f}M "
              f"params x {G} groups (f_w={f_w}, f_ps={f_ps}) on mesh "
              f"{mesh.sizes}, init {time.perf_counter() - t0:.1f}s")

    tree = state.split.local if state.split else state.tree
    rules = train_rules(mesh, bundle.cfg) if state.split else None
    loss_line = all(mesh.coord(a) == 0 for a in ("rep", "fsdp")
                    if mesh.size(a) > 1)
    stream = DeviceTokenStream(0, TokenSpec(bundle.cfg.vocab, args.seq), G,
                               args.batch_per_group, dev)
    stream.skip(start)
    traced = max(start, args.steps - args.T) if args.trace and lead else None
    prof = None
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        if i == traced:
            prof = _profiler(dev)
            prof.start()
        batch = {k: v[0] for k, v in stream.next(1).items()}
        ts = time.perf_counter()
        before = dict(mesh.sent)
        state = step(state, batch)
        devmod.synchronize(dev)
        run.step_s.append(time.perf_counter() - ts)
        run.sent.append({k: v - before.get(k, 0)
                         for k, v in mesh.sent.items()})
        if i % args.log_every == 0:
            # rank 0's 'model' line holds replica 0's blocks: it alone
            # computes the loss (tensor-parallel with M > 1)
            row = protocol.replica(state, 0, everywhere=False, blocks=True)
            if loss_line:
                with torch.no_grad(), sharding_rules(rules):
                    loss = float(bundle.loss(tree.unflatten(row),
                                             {k: v[0]
                                              for k, v in batch.items()}))
            if lead:
                run.losses.append((i, loss))
                print(f"[train] step {i:5d} loss {loss:8.4f} "
                      f"({time.perf_counter() - t0:.1f}s)")
            del row
        if args.ckpt_dir and (state.t % args.ckpt_every == 0
                              or state.t == args.steps):
            ck.save(args.ckpt_dir, state.t, state)
            if lead:
                print(f"[train] checkpoint @ {state.t}")
    if prof is not None:
        prof.stop()
        prof.export_chrome_trace(args.trace)
        print(f"[train] trace of steps {traced}-{args.steps - 1}: "
              f"{args.trace}")
    # the serving model: with a 'model' axis each rank keeps its blocks
    protocol.consolidate(state.params, pcfg, mesh=mesh,
                         n_params=state.tree.size, split=state.split,
                         blocks=True)
    devmod.synchronize(dev)
    if lead:
        print(f"[train] done: {args.steps} steps, "
              f"{state.tree.size / 1e6:.1f}M params, "
              f"{time.perf_counter() - t0:.1f}s")
    run.state = state
    return run


def _profiler(dev) -> torch.profiler.profile:
    """A profiler of the host's ops and spans, and of the card's kernels
    on a CUDA device."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


if __name__ == "__main__":
    main()

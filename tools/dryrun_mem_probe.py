#!/usr/bin/env python3
"""Which aten op of ``chip_smoke.py`` phase 18 (a)'s step allocates on the
card beyond the dry run's live bytes.

    python3 tools/dryrun_mem_probe.py

Runs phase 10's protocol step (phi4-mini-3.8b, depth 2, G = 4, ALIE x1,
4 x 1024 tokens a group) once to warm up, then once under a
``repro_torch.launch.dryrun.StepCounter`` that synchronises after every
aten op and prints each op that raised ``torch.cuda.max_memory_allocated``
by over 50 MB: its arguments' shapes, the rise, and the bytes the counter
holds live. A rise larger than the op's own outputs is a workspace inside
its CUDA kernel, which no dispatch-level count sees. Needs one NVIDIA GPU
and ``nvcc``.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> None:
    import chip_smoke as cs
    from repro_torch import device as devmod
    from repro_torch.core import protocol
    from repro_torch.core.attacks import ByzantineSpec
    from repro_torch.data.pipeline import token_stream
    from repro_torch.kernels import _build, work
    from repro_torch.launch import dryrun, train
    from repro_torch.models.registry import get_bundle
    from repro_torch.optim.schedules import inverse_linear

    dev = devmod.resolve("cuda")
    print(f"[probe] {cs.card_line()}", flush=True)
    _build.build()
    args = train.parser().parse_args(cs.PROTO_ARGV)
    bundle = get_bundle(args.arch, depth=args.depth)
    pcfg = train.protocol_config(args.groups, args.T, args.engine,
                                 ByzantineSpec(worker_attack="alie",
                                               n_byz_workers=args.n_byz))
    lr = inverse_linear(args.lr, 0.005)
    state = protocol.make_init_fn(bundle, pcfg, dev)(0)
    batch = next(token_stream(cs.SEED + 2, bundle.cfg.vocab, args.groups,
                              args.batch_per_group, args.seq, 1, device=dev))
    step = protocol.make_scatter_step(bundle, pcfg, lr, with_attack=True)
    state = step(state, batch)                # warm: libraries, handles
    del step
    torch.cuda.synchronize()

    class Probe(dryrun.StepCounter):
        def __init__(self, args):
            super().__init__(args)
            self.rows = []
            self.high = torch.cuda.max_memory_allocated()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            torch.cuda.synchronize()
            high = torch.cuda.max_memory_allocated()
            if high > self.high + 50e6:
                shapes = [tuple(a.shape) for a in dryrun._flat(args)][:4]
                self.rows.append((str(func), shapes, (high - self.high) / 1e9,
                                  self.live / 1e9))
            self.high = max(self.high, high)
            return out

    torch.cuda.reset_peak_memory_stats()
    probe = Probe((state, batch))
    step = protocol.make_scatter_step(bundle, pcfg, lr, with_attack=True)
    with work.active(probe), probe:
        step(state, batch)
    torch.cuda.synchronize()
    print(f"[probe] arguments {sum(probe.args.values()) / 1e9:.3f} GB, the "
          f"counter's peak of new storages {probe.peak / 1e9:.3f} GB, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.3f}"
          f" GB")
    for op, shapes, rise, live in probe.rows:
        print(f"[probe] {op} {shapes}: max_memory_allocated +{rise:.3f} GB, "
              f"the counter's live bytes after it {live:.3f} GB")


if __name__ == "__main__":
    main()

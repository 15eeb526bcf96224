"""The readings the comparison's limits are set from: for each seed, the
program (sound, or with the lower-precision control or a planted fault)
through the checked steps, then the plain reference, and the numbers of
:mod:`bench.compare` with the loss gap of each step, MDA's least margin,
the count of the program's picks other than the reference's best, and
the leaves that gave the largest gaps, one JSON line each. No window is run, and every
seed shares the process's set-up:

    python -m bench.calibrate --workload phi4-1k --out readings.jsonl \\
        sound=101-112 control=113-115 half_batch=116-118

Each ``mode=seeds`` item runs its seeds (``a-b`` ranges, ``,`` between)
in one of the modes: ``sound``, ``control`` (the replicas in bfloat16,
the program's own path one precision below the configuration's float32),
or a fault of :data:`bench.program.FAULTS`.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from . import compare, program, spec
from .reference import protocol as ref
from .run import _free, card_line, checked_steps, reference


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def worst(prog, want, c) -> dict:
    """The leaf with the largest gap of each leaf-wise number."""
    names = [p for p, *_ in ref.spans(c)]
    out = {}
    for key in ("first", "change"):
        p, r = prog[key], want[key]
        if p is None or p.shape != r.shape:
            continue
        gap = np.abs(p - r) / np.maximum(r, np.median(r, axis=1,
                                                      keepdims=True))
        g, i = np.unravel_index(np.argmax(gap), gap.shape)
        out[key] = [names[i], int(g), float(p[g, i]), float(r[g, i])]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("plan", nargs="+", help="mode=seeds items")
    args = ap.parse_args(argv)
    modes = ("sound", "control") + program.FAULTS
    plan = [(m, seeds(rest)) for m, _, rest in
            (item.partition("=") for item in args.plan)]
    for m, _ in plan:
        if m not in modes:
            ap.error(f"mode {m!r}: one of {modes}")
    cell = spec.load_cell(args.workload)
    control = dataclasses.replace(cell, config={**cell.config,
                                                "param_dtype": "bfloat16"})
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(f"[calibrate] card: {card_line()}", file=sys.stderr)
        program.build_kernels()
    with open(args.out, "a") as f:
        for mode, seed in ((m, s) for m, ss in plan for s in ss):
            t0 = time.perf_counter()
            prog, feed, batches, got = checked_steps(
                control if mode == "control" else cell, seed, dev,
                fault=None if mode in ("sound", "control") else mode)
            prog.free()
            del prog, feed
            _free(dev)
            t1 = time.perf_counter()
            want = reference(cell, seed, dev, batches, got["picks"])
            numbers = compare.gaps(got, want, cell.limits)
            lp, lr = got["losses"], want["losses"]
            ok = lp.shape == lr.shape
            by_step = (np.max(np.abs(lp - lr) / np.abs(lr), axis=1).tolist()
                       if ok else None)
            mean_first = (float(np.mean(np.abs(lp[0] - lr[0]) / lr[0]))
                          if ok else None)
            line = dict(workload=cell.name, mode=mode, seed=seed, **numbers,
                        loss_gap_by_step=by_step,
                        loss_gap_first_mean=mean_first,
                        select_gap_by_step=want["select_gaps"],
                        mda_margin=want["mda_margin"],
                        other_picks=want["other_picks"],
                        worst=worst(got, want, cell.config),
                        program_s=t1 - t0,
                        reference_s=time.perf_counter() - t1)
            print(json.dumps(line), file=f, flush=True)
            print(json.dumps(line), flush=True)
            del batches, got, want
            _free(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Steps/s of the single-host training runs on this tree against another
checkout, on one card, in turns.

    python3 tools/train_steps_turns.py OTHER

OTHER is a checkout of another commit of this repository (one unpacked with
``git archive``). Each turn is a fresh process on one tree: it builds that
tree's kernels, warms up with a 20-step ``quickstart`` run, then runs
``quickstart`` (150 steps) and ``sync_filters`` (100 steps) at
``mlp_h1024`` through ``repro_torch.exp.run`` on the card and prints their
steps/s. The turns go OTHER, this tree, this tree, OTHER, so a drift of the
host's pace over the call falls on both alike; these runs are host-bound,
and their steps/s move 2x between calls (PERF.md), so only a comparison
inside one call means anything. Needs one NVIDIA GPU and ``nvcc``.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
RUNS = (("quickstart", 150), ("sync_filters", 100))

TURN = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch import exp
exp.run("quickstart", device="cuda", model="mlp_h1024", steps=20)
out = {}
for name, steps in json.loads(sys.argv[2]):
    res = exp.run(name, device="cuda", model="mlp_h1024", steps=steps)
    torch.cuda.synchronize()
    out[name] = steps / res.wall_s
print(json.dumps(out))
"""


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    trees = {"other": Path(argv[0]).resolve() / "src", "this": ROOT / "src"}
    got = {k: {name: [] for name, _ in RUNS} for k in trees}
    for tag in ("other", "this", "this", "other"):
        proc = subprocess.run([sys.executable, "-c", TURN, str(trees[tag]),
                               json.dumps(RUNS)], capture_output=True,
                              text=True, cwd=trees[tag].parent)
        if proc.returncode:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"[turn] {tag}: " + ", ".join(f"{k} {v:.2f} steps/s"
                                            for k, v in res.items()),
              flush=True)
        for k, v in res.items():
            got[tag][k].append(v)
    for name, _ in RUNS:
        print(f"[steps/s] {name} mlp_h1024: other "
              f"{np.mean(got['other'][name]):.2f}, this "
              f"{np.mean(got['this'][name]):.2f} (mean of two turns each)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

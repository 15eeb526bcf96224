#!/usr/bin/env python3
"""How many blocks the Gram kernel should spread a launch over.

    python3 tools/gram_target_blocks.py

``pairwise_sqdist.ops.chunking`` splits d into about ``TARGET_BLOCKS``
chunks of whole 128-column tiles, one block each, and ``gram_finish_kernel``
then adds the chunks' partial Grams. This script times ``gram`` at the
training paths' two shapes (the protocol's ``[4, 815,938,560]`` and
mlp_h1024's ``[5, 7, 1,093,642]``) for several values of ``TARGET_BLOCKS``,
each cold in L2 from a CUDA graph (``chip_smoke.cold_ms``), in turns: the
values in order, then in reverse, so a drift of the card's clock over the
run falls on every value alike. Needs one NVIDIA GPU and ``nvcc``.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

VALUES = (132, 264, 528, 1056, 2112)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels.pairwise_sqdist import ops

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    shipped = ops.TARGET_BLOCKS
    for shape, iters in (((5, 7, 1_093_642), 100), ((4, 815_938_560), 3)):
        x = 0.05 * torch.randn(shape, generator=g, device=dev)
        times = {v: [] for v in VALUES}
        for v in VALUES + VALUES[::-1]:
            ops.TARGET_BLOCKS = v
            times[v].append(chip_smoke.cold_ms(ops.gram, (x,), iters))
        for v, ts in times.items():
            ops.TARGET_BLOCKS = v
            chunks = ops.launch_plan(x[..., 0, 0].numel(), *shape[-2:],
                                     x.data_ptr()).n_chunks
            print(f"gram {list(shape)} TARGET_BLOCKS {v} ({chunks} chunks a "
                  f"stack): " + ", ".join(f"{t:.4f}" for t in ts) + " ms",
                  flush=True)
        ops.TARGET_BLOCKS = shipped
        del x
    return 0


if __name__ == "__main__":
    sys.exit(main())

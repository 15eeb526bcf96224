#!/usr/bin/env python3
"""Run parts of ``chip_smoke.py``'s phases 16 and 17 (the 'model' axis,
tensor parallelism, over ranks sharing the card) alone on the card.

    python3 tools/tp_phase.py [a] [b] [z]

a: phi4-mini-3.8b through ``launch/serve.py --mesh 1x2`` against one rank,
then the quorum run at model 2; b: phi4-mini-3.8b protocol training
through ``launch/train.py --mesh 4x2`` (8 ranks), then, on the same ranks,
``lm/tfm_tiny`` at (rep 4, fsdp 1, model 2) against the CPU (part c) and
phase 17 (c) and (d) (zamba2-1.2b through ``launch/train.py --mesh 4x2``,
the reduced MoE and hybrid against the CPU); z: phase 17 (a) and (b), the
MoE, RWKV6, hybrid and audio models through ``launch/serve.py --mesh
1x2`` against one rank and their quorum runs at model 2. All three when
none is named.
Builds the kernels first and runs the parts with their gates. Needs one
NVIDIA GPU and ``nvcc``.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv) -> int:
    import chip_smoke as cs
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("tp_phase: needs an NVIDIA GPU (CUDA)", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cs.log(f"[card] {cs.card_line()} | torch {torch.__version__}")
    t0 = time.perf_counter()
    for text in _build.build().values():
        cs.PTXAS.update(_build.ptxas_usage(text))
    cs.log(f"[build] {time.perf_counter() - t0:.1f} s")
    parts = "".join(argv) or "abz"
    t0 = time.perf_counter()
    got = cs.tp_phase(dev, parts.replace("z", ""), zoo="b" in parts)
    got17 = cs.tp_zoo_phase(dev, "a" if "z" in parts else "")
    cs.log(f"[tp] parts {parts}: {time.perf_counter() - t0:.1f} s; launches "
           f"{got}, phase 17 {got17}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

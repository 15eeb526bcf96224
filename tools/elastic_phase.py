#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 12 (c) (the elastic runner on one card)
and phase 20 (the elastic runner on 8 ranks sharing the card, held against
12 (c)'s run) alone on the card.

    python3 tools/elastic_phase.py

Builds the kernels first and runs both phases with their gates. Needs one
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


def main() -> int:
    import chip_smoke as cs
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("elastic_phase: needs an NVIDIA GPU (CUDA)", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cs.log(f"[card] {cs.card_line()} | torch {torch.__version__}")
    t0 = time.perf_counter()
    for text in _build.build().values():
        cs.PTXAS.update(_build.ptxas_usage(text))
    cs.log(f"[build] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _, reference = cs.elastic_phase(dev)
    cs.log(f"[elastic] phase 12 (c) took {time.perf_counter() - t0:.1f} s")
    got = cs.elastic_ranks_phase(dev, reference)
    cs.log(f"[elastic-ranks] launches over the ranks {got}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

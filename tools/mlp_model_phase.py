#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 21 (the paper's MLP at ``mlp_h1024`` on 4
ranks sharing the card at (rep 2, fsdp 1, model 2), held against the same
spec on one card) alone on the card.

    python3 tools/mlp_model_phase.py

Builds the kernels first and runs the phase with its gates. Needs one
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
        print("mlp_model_phase: needs an NVIDIA GPU (CUDA)", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cs.log(f"[card] {cs.card_line()} | torch {torch.__version__}")
    t0 = time.perf_counter()
    for text in _build.build().values():
        cs.PTXAS.update(_build.ptxas_usage(text))
    cs.log(f"[build] {time.perf_counter() - t0:.1f} s")
    got = cs.mlp_model_phase(dev)
    cs.log(f"[mlp-model] launches over the ranks {got}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

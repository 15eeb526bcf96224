#!/usr/bin/env python3
"""Run parts of ``chip_smoke.py``'s phases 13 and 14 (the zoo) alone on
the card.

    python3 tools/zoo_phases.py [a] [b] [c] [d] [e] [14a] ... [14f]

Phase 13 — a: the flash forward at qwen3-moe's heads and the WKV
scan's chunk-recurrence kernels at rwkv6-4k's training shape; b:
qwen3-moe-235b-a22b quorum serving at depth 2; c: rwkv6-3b protocol
training at depth 2 through ``launch/train.py``, with the WKV scan's share
of a profiler window; d: rwkv6-3b quorum serving at depth 8; e:
``lm/moe_tiny`` and ``lm/rwkv_tiny`` card against CPU. Phase 14 — 14a:
the flash forward, dq and dkv at the whisper-small, zamba2-1.2b and
qwen2-vl-7b shapes; 14b: qwen2-vl-7b serving through ``launch/serve.py``;
14c: zamba2-1.2b quorum serving at depth 12; 14d: zamba2-1.2b protocol
training at depth 12, with the SSD scan's share; 14e: whisper-small
serving and protocol training; 14f: the three families reduced, card
against CPU. All of them when none is named. Builds the kernels first,
runs each part with its gates, and reports each part as passed or failed
with its traceback, going on to the next. Exits non-zero if a part
failed. Needs one NVIDIA GPU and ``nvcc``.
"""
from __future__ import annotations

import gc
import sys
import time
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main(argv) -> int:
    import chip_smoke as cs
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        print("zoo_phases: needs an NVIDIA GPU (CUDA)", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cs.log(f"[card] {cs.card_line()} | torch {torch.__version__}")
    t0 = time.perf_counter()
    for text in _build.build().values():
        cs.PTXAS.update(_build.ptxas_usage(text))
    cs.log(f"[build] {time.perf_counter() - t0:.1f} s")

    def kernels():
        with torch.inference_mode():
            cs.flash_row(dev, 1, 1024, 64, 4, 64, 0, tag="zoo-kernel")
        cs.wkv_scan_phase(dev)

    parts = {"a": kernels,
             "b": lambda: cs.zoo_serve_phase(dev, *cs.ZOO_SERVE[0]),
             "c": lambda: cs.zoo_train_phase(dev),
             "d": lambda: cs.zoo_serve_phase(dev, *cs.ZOO_SERVE[1]),
             "e": lambda: cs.zoo_reference_phase(dev),
             "14a": lambda: cs.zoo2_kernel_phase(dev),
             "14b": lambda: cs.vlm_serve_phase(dev),
             "14c": lambda: cs.zoo_serve_phase(dev, *cs.HYBRID_SERVE),
             "14d": lambda: cs.hybrid_train_phase(dev),
             "14e": lambda: cs.audio_phase(dev),
             "14f": lambda: cs.zoo2_reference_phase(dev)}
    failed = []
    for key in argv or list(parts):
        t0 = time.perf_counter()
        try:
            parts[key]()
        except Exception:  # report the part and go on to the next one
            traceback.print_exc()
            failed.append(key)
        cs.log(f"[zoo-phases] {key}: "
               f"{'FAILED' if key in failed else 'passed'} in "
               f"{time.perf_counter() - t0:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

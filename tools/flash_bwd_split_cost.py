#!/usr/bin/env python3
"""What the bf16 backward pays for taking p and ds as two bf16 parts.

    python3 tools/flash_bwd_split_cost.py

The bf16 dq and dkv kernels (``flash_bwd.cu``) feed p and ds to their
second products as hi = bf16(x) and lo = bf16(x - hi), one ``wgmma`` each.
This script builds a variant of the source without the lo products (hi
alone: p and ds rounded to bf16 once, as FlashAttention does) into the
git-ignored build directory, and times both at the protocol run's shape
(B 4, S 1024 causal, 24 / 8 heads, hd 128), each kernel cold in L2 from a
CUDA graph, in turns: split, hi, hi, split. It also counts the outputs of
each that miss ``chip_smoke.py``'s gate, |a - w| <= 1e-3 + 2^-7 |w|,
against the plain backward. Needs one NVIDIA GPU and ``nvcc``.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_bwd_from_delta, flash_delta)

    shipped = _build.SOURCES["flash_attention_bwd"]
    variant = _build.BUILD_DIR / "hi-only" / shipped.name
    variant.parent.mkdir(parents=True, exist_ok=True)
    lines = shipped.read_text().splitlines(keepends=True)
    kept = [l for l in lines if not ("wgmma_rs(" in l and "lo[kk]" in l)]
    if len(lines) - len(kept) != 3:
        raise RuntimeError(f"{shipped.name}: expected three lo products")
    variant.write_text("".join(kept))
    for header in shipped.parent.glob("*.cuh"):
        (variant.parent / header.name).write_text(header.read_text())

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B, S, H, kvH = 4, 1024, 24, 8
    q, do = (torch.randn((B, S, H, 128), generator=g, device=dev).bfloat16()
             for _ in range(2))
    k, v = (torch.randn((B, S, kvH, 128), generator=g, device=dev).bfloat16()
            for _ in range(2))
    o, lse = ops.flash_attention(q, k, v, causal=True)
    delta = flash_delta(o, do).contiguous()
    kw = dict(scale=128 ** -0.5, causal=True, window=0)
    want = flash_bwd_from_delta(q, k, v, do, lse, delta, causal=True)
    args = (q, k, v, do, lse, delta)
    for label, src in (("hi + lo", shipped), ("hi", variant),
                       ("hi", variant), ("hi + lo", shipped)):
        _build.SOURCES["flash_attention_bwd"] = src
        _build._LOADED.pop("flash_attention_bwd", None)
        got = (ops.flash_bwd_dq(*args, **kw),) + ops.flash_bwd_dkv(*args, **kw)
        miss = [int(((a.float() - w.float()).abs()
                     > 1e-3 + 2 ** -7 * w.float().abs()).sum())
                for a, w in zip(got, want)]
        dq_ms = chip_smoke.cold_ms(lambda *t: ops.flash_bwd_dq(*t, **kw),
                                   args, 20)
        dkv_ms = chip_smoke.cold_ms(lambda *t: ops.flash_bwd_dkv(*t, **kw),
                                    args, 20)
        print(f"{label:8s} dq {dq_ms:.4f} ms, dkv {dkv_ms:.4f} ms; outputs "
              f"past the gate (dq / dk / dv): {miss[0]} / {miss[1]} / "
              f"{miss[2]}", flush=True)
    _build.SOURCES["flash_attention_bwd"] = shipped
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   CUDA kernels from ``src/repro_torch/kernels/*/csrc`` (one ``nvcc`` per
   source, all at once).
2. Kernel phase: each kernel against its plain PyTorch version on the card
   at the serving path's shapes, with the stated tolerance, and the times of
   the kernel, of the plain version and of one PyTorch library call as a
   yardstick (each with its inputs cold in L2), beside the least time the
   card could take (bound).
3. Reference phase: a reduced model (hd 128, f32 activations) through the
   kernels on the card against the same model on the CPU's plain path.
4. Serve phase: phi4-mini-3.8b at full width and depth, random bf16 weights
   from a seed, four replicas (one corrupted with ``reversed``) behind
   ``QuorumService(n_slots=4, rule="median")``: 8 requests with prompt
   lengths 64-1024 and 16 new tokens each. The continuations must be
   token-identical to an honest single replica, and both kernels must have
   been launched by that run.

Phases print on earlier lines; the line before the last holds the card's
name and power limit, the one before it the kernels' JSON record, and the
last line is ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result line, when CUDA is absent or any check fails.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor-core FLOP/s,
# f32 FLOP/s outside the tensor cores; and its L2 size
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
L2_BYTES = 50 * 2**20

SEED = 0
N_REPLICAS, F_BYZ, N_SLOTS, N_REQUESTS, MAX_NEW = 4, 1, 4, 8, 16


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cold_ms(fn, args, iters: int, warmup: int = 2) -> float:
    """Mean device time of one ``fn(*args)`` call with a cold L2, the
    condition the HBM bound assumes: the calls cycle through copies of
    ``args`` that together span three times the L2, so no call finds its
    inputs there. The calls are captured in a CUDA graph and replayed, so
    the host's per-call cost (Python, ctypes, allocation) does not hide the
    device time of a microsecond kernel."""
    nbytes = sum(t.numel() * t.element_size() for t in args)
    sets = [args] + [tuple(t.clone() for t in args)
                     for _ in range(-(-3 * L2_BYTES // nbytes))]
    for i in range(warmup):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def bound(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def flash_phase(dev):
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    B, H, kvH, hd = N_REPLICAS, 24, 8, 128      # R*H = 96 rows, phi4 heads
    rows = []
    for S, window in ((128, 0), (1000, 0), (1000, 256)):
        g = torch.Generator(device=dev).manual_seed(S + window)
        q = torch.randn((B, S, H, hd), generator=g, device=dev).bfloat16()
        k = torch.randn((B, S, kvH, hd), generator=g, device=dev).bfloat16()
        v = torch.randn((B, S, kvH, hd), generator=g, device=dev).bfloat16()
        o, lse = ops.flash_attention(q, k, v, causal=True, window=window)
        po, plse = attention_ref(q, k, v, causal=True, window=window,
                                 return_lse=True)
        torch.cuda.synchronize()
        err = (o.float() - po.float()).abs().max().item()
        lse_err = (lse - plse).abs().max().item()
        # o: one bf16 step of the output, and the plain version's bf16
        # rounding of p (as the JAX oracle's); lse: f32 summation order
        torch.testing.assert_close(o.float(), po.float(), rtol=1e-2, atol=1e-2)
        torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-4)
        iters = 20 if S > 500 else 100
        ms = cold_ms(lambda *t: ops.flash_attention(*t, causal=True,
                                                    window=window),
                     (q, k, v), iters)
        plain_ms = cold_ms(lambda *t: attention_ref(*t, causal=True,
                                                    window=window),
                           (q, k, v), max(iters // 4, 5))
        if window:
            i = torch.arange(S, device=dev)
            mask = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
            lib = dict(attn_mask=mask)
        else:
            lib = dict(is_causal=True)
        library_ms = cold_ms(lambda *t: F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in t), enable_gqa=True, **lib),
            (q, k, v), iters)
        # the work these inputs need: visible (q, k) pairs only
        i = np.arange(S)
        lo = np.maximum(0, i - window + 1) if window else 0
        pairs = int(np.sum(i + 1 - lo))
        flops = 4.0 * hd * pairs * B * H                    # QK^T and PV
        nbytes = 2.0 * (2 * B * S * H * hd + 2 * B * S * kvH * hd) \
            + 4.0 * B * H * S
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        log(f"[kernel] flash_attention S={S} window={window} rows={B * H}: "
            f"max|o-plain|={err:.3g} max|lse-plain|={lse_err:.3g} | "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
            f"{library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{flops / ms / 1e9:.1f} TFLOP/s")
        rows.append(dict(S=S, window=window, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=b_ms, bound_by=b_by))
    return rows


def median_phase(dev):
    from repro_torch.kernels.cwise_median import ops
    from repro_torch.kernels.cwise_median.ref import _oddeven_pairs
    D = N_SLOTS * 200064                                 # [R, slots * V]
    rows = []
    for n in (4, 3):
        g = torch.Generator(device=dev).manual_seed(n)
        x = torch.randn((n, D), generator=g, device=dev)
        x[-1] = float("nan")                             # a NaN payload row
        got = ops.cwise_median(x)
        want = ops.cwise_median_plain(x)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        # exact: the same order statistic and the same f32 average
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        ms = cold_ms(ops.cwise_median, (x,), 200)
        plain_ms = cold_ms(ops.cwise_median_plain, (x,), 50)
        library_ms = cold_ms(lambda t: torch.quantile(t, 0.5, dim=0), (x,), 50)
        nbytes = 4.0 * (n * D + D)
        b_ms, b_by = bound(nbytes, 2.0 * len(_oddeven_pairs(n)) * D,
                           F32_FLOPS)
        log(f"[kernel] cwise_median [{n}, {D}] f32: max|kernel-plain|={err} "
            f"| kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, quantile "
            f"{library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{nbytes / ms / 1e6:.1f} GB/s")
        rows.append(dict(n=n, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=b_ms, bound_by=b_by))
    return rows


# ---------------------------------------------------------------------------
# reference and serve phases
# ---------------------------------------------------------------------------

def reference_phase(dev):
    """A reduced model through the kernels vs the CPU's plain path."""
    from repro_torch.models.registry import get_bundle
    from repro_torch.serve.replica import tree_map
    tb = get_bundle("phi4-mini-3.8b", reduced=True, head_dim=128,
                    act_dtype="float32")
    params = tb.init(torch.Generator().manual_seed(SEED))
    toks = torch.randint(0, tb.cfg.vocab, (2, 200),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for d in (torch.device("cpu"), dev):
        p = tree_map(lambda t: t.to(d), params)
        c = tb.init_caches(2, max_len=256, n_chunks=4, device=d)
        lg, c = tb.prefill(p, {"tokens": toks.to(d)}, c)
        logits = [lg]
        for _ in range(4):
            lg, c = tb.decode(p, c, {"token": torch.argmax(lg, -1)[:, None]})
            logits.append(lg)
        out[d.type] = torch.stack(logits).cpu()
    err = (out["cuda"] - out["cpu"]).abs().max().item()
    if not torch.isfinite(out["cuda"]).all():
        raise AssertionError("non-finite logits on the card")
    # f32 on both sides; the sums run in other orders
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-3, atol=1e-3)
    log(f"[reference] reduced model (hd 128, f32), prefill 200 + 4 decode "
        f"steps: card kernels vs CPU plain path max|diff|={err:.3g}")


def serve_phase(dev):
    from repro_torch.core.attacks import ByzantineSpec
    from repro_torch.kernels.cwise_median import ops as median_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.registry import get_bundle
    from repro_torch.serve import QuorumService, ReplicaPool
    from repro_torch.serve.replica import leaves

    bundle = get_bundle("phi4-mini-3.8b")
    cfg = bundle.cfg
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(SEED),
                         dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, vocab "
        f"{cfg.vocab}: {n_params / 1e9:.3f} B params bf16, init "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 1025, size=N_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    max_len = -(-(int(lens.max()) + MAX_NEW + 1) // 64) * 64
    kw = dict(n_slots=N_SLOTS, max_len=max_len, n_chunks=4, rule="median")

    t0 = time.perf_counter()
    pool = ReplicaPool.from_params(params, N_REPLICAS, f=F_BYZ).corrupt(
        ByzantineSpec(server_attack="reversed", n_byz_servers=1))
    torch.cuda.synchronize()
    log(f"[serve] pool: {N_REPLICAS} replicas (f={F_BYZ}), replica "
        f"{N_REPLICAS - 1} corrupted (reversed), "
        f"{time.perf_counter() - t0:.1f} s; prompt lengths {lens.tolist()}")
    svc = QuorumService(pool, bundle, **kw)

    torch.cuda.reset_peak_memory_stats(dev)
    flash_ops.flash_attention.launches = 0
    median_ops.cwise_median.launches = 0
    t0 = time.perf_counter()
    outs = svc.generate(prompts, max_new=MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_ops.flash_attention.launches,
                "cwise_median": median_ops.cwise_median.launches}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    rep = svc.report()
    rep.pop("replicas")
    log(f"[serve] quorum run: {rep['committed_tokens']} tokens in "
        f"{wall:.2f} s wall, peak device memory {peak_gb:.1f} GB, kernel "
        f"launches {launches}")
    log("[serve] report " + json.dumps(rep))

    base_svc = QuorumService(ReplicaPool.from_params(params, 1, f=0), bundle,
                             **kw)
    base = base_svc.generate(prompts, max_new=MAX_NEW)
    log(f"[serve] honest single replica: {base_svc.report()['tok_s']:.2f} "
        f"tok/s (the quorum run: {rep['tok_s']:.2f} tok/s)")
    if outs != base:
        bad = [i for i, (a, b) in enumerate(zip(outs, base)) if a != b]
        raise AssertionError(f"requests {bad} differ from the honest "
                             f"single replica")
    if any(len(o) != MAX_NEW for o in outs):
        raise AssertionError("a request did not reach max_new tokens")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{name} kernel was not launched by the "
                                 f"serve run")
    log(f"[serve] token-identical to the honest single replica "
        f"({len(outs)} requests x {MAX_NEW} tokens); sample "
        f"{outs[0][:8]}; launches per committed token: "
        + ", ".join(f"{k} {v / rep['committed_tokens']:.3f}"
                    for k, v in launches.items()))
    profile_window(svc, [rng.integers(0, cfg.vocab, 256).tolist()
                         for _ in range(N_SLOTS)])
    return launches, rep


def profile_window(svc, prompts, max_new: int = 8):
    """Where the serve time goes: one short quorum run (a prefill of 256
    tokens per slot, then decode) under torch.profiler; device busy share
    and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.generate(prompts, max_new=max_new)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    log(f"[profile] {len(prompts)} x 256-token prefill + {max_new} tokens "
        f"each on {svc.pool.n_replicas} replicas: wall {wall_us / 1e3:.1f} "
        f"ms, device busy {busy_us / 1e3:.1f} ms "
        f"({100 * busy_us / wall_us:.1f}% of wall)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:6d} x  {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import device as devmod
    from repro_torch.kernels import _build

    dev = devmod.resolve("cuda")
    card = card_line()
    log(f"[card] {card} | torch {torch.__version__} (CUDA "
        f"{torch.version.cuda}) | ninja: {shutil.which('ninja') or 'absent'}")
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"[build] {len(reports)} kernel libraries built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    with torch.inference_mode():
        flash = flash_phase(dev)
        median = median_phase(dev)
        reference_phase(dev)
        launches, _ = serve_phase(dev)

    main_flash = max(flash, key=lambda r: (r["S"], -r["window"]))
    main_median = next(r for r in median if r["n"] == N_REPLICAS)
    kernels = []
    for name, src, replaces, main_row, rows in (
            ("flash_attention", "flash_attention/csrc/flash_fwd.cu",
             "src/repro/kernels/flash_attention/kernel.py:28", main_flash,
             flash),
            ("cwise_median", "cwise_median/csrc/cwise_median.cu",
             "src/repro/kernels/cwise_median/kernel.py:54", main_median,
             median)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

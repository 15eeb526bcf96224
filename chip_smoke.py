#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   CUDA kernels from ``src/repro_torch/kernels/*/csrc`` (one ``nvcc`` per
   source, all at once).
2. Kernel phase: each kernel against its plain PyTorch version on the card
   at the serving path's shapes (the flash forward also at the protocol
   run's), with the stated tolerance, two launches of the flash forward
   bit-equal, and the times of the kernel, of the plain version and of one
   PyTorch library call as a yardstick (each with its inputs cold in L2),
   beside the least time the card could take (bound) and the kernel's
   ``ptxas`` registers and spill.
3. Reference phase: a reduced model (hd 128, f32 activations) through the
   kernels on the card against the same model on the CPU's plain path.
4. Serve phase: phi4-mini-3.8b at full width and depth, random bf16 weights
   from a seed, four replicas (one corrupted with ``reversed``) behind
   ``QuorumService(n_slots=4, rule="median")``: 8 requests with prompt
   lengths 64-1024 and 16 new tokens each. The continuations must be
   token-identical to an honest single replica, and both kernels must have
   been launched by that run.
5. Training kernel phase: the batched median, the trimmed mean, MeaMed, the
   Gram and the subset diameters against their plain versions at the
   training path's shapes (the ``mlp_h1024`` model, D = 1,093,642), timed as
   in 2.
6. Train reference phase: ``quickstart`` at ``mlp_h1024`` for 2T + 3 = 23
   steps on fixed quorum tables and numpy batches, on the card (kernels)
   and on the CPU (plain versions): params within the stated tolerance and
   every MDA selection the same.
7. Train phase: three fused runs on the card through ``repro_torch.exp.run``
   — ``quickstart`` (150 steps), ``sync_filters`` (100 steps) and the
   attack gallery's point (ALIE x2, ``gar="trimmed_mean"``, 120 steps), all
   at ``mlp_h1024`` — each with steps/s, final accuracy (finite, above 0.2),
   peak memory and its kernel launches; and a profiler window on
   ``quickstart`` for the device busy share.
8. Flash backward phase: the dq and dkv kernels against the plain backward
   on the card at the protocol run's shape (B 4, S 1024, 24 / 8 heads, hd
   128, bf16, causal), a ragged windowed GQA case and a padded hd 32 case:
   error and tolerance, two launches bit-equal, each kernel's time beside
   its bound, the plain version's and the library's (the backward of
   ``scaled_dot_product_attention``, a yardstick only).
9. Protocol reference phase: ``lm/tfm_tiny`` in float32 (hd 32, padded in
   the kernels) through the port's ``ProtocolEngine`` for 2T + 1 steps on
   fixed quorum tables and numpy token batches, an ALIE worker: the card
   against the CPU, params within the stated tolerance and every MDA
   selection the same.
10. Protocol train phase: phi4-mini-3.8b at full width, depth 2, through
   ``python -m repro_torch.launch.train`` — G = 4 groups on the card (f_w =
   1, f_ps = 0), ALIE on one worker, T = 5, 11 steps of 4 x 1024 Zipf tokens
   per group, sgd: finite, falling losses, steps/s, peak memory (under 80 GB),
   launches per kernel per step (the flash forward, dq and dkv among them)
   and a profiler window; then ``exp.run("lm/tfm_tiny")`` on the card.

Phases print on earlier lines; the line before the last holds the card's
name and power limit, the one before it the kernels' JSON record, and the
last line is ``{"ok": true, "device": {...}}``. Exits non-zero, with no
result line, when CUDA is absent or any check fails.
"""
from __future__ import annotations

import gc
import json
import re
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
D_MLP_H1024 = 32 * 1024 + 1024 + 1024 * 1024 + 1024 + 1024 * 10 + 10
N_REPLICAS, F_BYZ, N_SLOTS, N_REQUESTS, MAX_NEW = 4, 1, 4, 8, 16


def log(msg: str) -> None:
    print(msg, flush=True)


#: mangled kernel name -> (registers, spill store bytes, spill load bytes),
#: from this run's build (``_build.ptxas_usage``)
PTXAS: dict[str, tuple[int, int, int]] = {}


def ptxas_note(fragment: str) -> str:
    """``ptxas`` registers and spill of the kernel whose mangled name holds
    ``fragment``, as this run's build reported them."""
    hits = [v for k, v in PTXAS.items() if fragment in k]
    if not hits:
        return f"; ptxas: no report for {fragment} (library not built here)"
    regs, st, ld = hits[0]
    return f"; ptxas {regs} registers, spill {st} B stores / {ld} B loads"


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
                     for _ in range(-(-3 * L2_BYTES // nbytes) - 1)]
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
    # serving's prefills (S 128 and 1000, causal and windowed) and the
    # protocol run's shape (S 1024)
    for S, window in ((128, 0), (1000, 0), (1000, 256), (1024, 0)):
        g = torch.Generator(device=dev).manual_seed(S + window)
        q = torch.randn((B, S, H, hd), generator=g, device=dev).bfloat16()
        k = torch.randn((B, S, kvH, hd), generator=g, device=dev).bfloat16()
        v = torch.randn((B, S, kvH, hd), generator=g, device=dev).bfloat16()
        o, lse = ops.flash_attention(q, k, v, causal=True, window=window)
        o2, lse2 = ops.flash_attention(q, k, v, causal=True, window=window)
        po, plse = attention_ref(q, k, v, causal=True, window=window,
                                 return_lse=True)
        torch.cuda.synchronize()
        same = torch.equal(o, o2) and torch.equal(lse, lse2)
        if not same:
            raise AssertionError(f"flash forward S={S} window={window} is "
                                 f"not deterministic")
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
            f"max|o-plain|={err:.3g} max|lse-plain|={lse_err:.3g}, two "
            f"launches bit-equal {same} | kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {b_ms:.4f} "
            f"ms ({b_by}), {flops / ms / 1e9:.1f} TFLOP/s, "
            f"{100 * b_ms / ms:.1f} % of the bound"
            + ptxas_note("tc10fwd_kernel"))
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
            f"{nbytes / ms / 1e6:.1f} GB/s, {100 * b_ms / ms:.1f} % of the "
            f"bound")
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
    tokens per slot, then decode) under torch.profiler."""
    _profile(f"{len(prompts)} x 256-token prefill + {max_new} tokens each on "
             f"{svc.pool.n_replicas} replicas",
             lambda: svc.generate(prompts, max_new=max_new))


def _profile(label: str, fn) -> float:
    """Run ``fn`` under torch.profiler: device busy share of the wall time
    and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    log(f"[profile] {label}: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}% of wall)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.count:6d} x  {e.key[:90]}")
    return busy_us / wall_us


# ---------------------------------------------------------------------------
# training phases (the ByzSGD loop on mlp_h1024)
# ---------------------------------------------------------------------------

TRAIN_MODEL = "mlp_h1024"
REF_STEPS = 23                                   # 2T + 3 at T = 10


def _bitonic_ops(n: int) -> int:
    """min/max operations per column of the bitonic network over n rows
    padded to a power of two: np2 / 2 compare-exchanges (two operations
    each) in each of its log2(np2) (log2(np2) + 1) / 2 stages."""
    lg = max(n - 1, 0).bit_length()
    return (1 << lg) * lg * (lg + 1) // 2


def _row(label, err, ms, plain_ms, library_ms, nbytes, ops, extra=""):
    b_ms, b_by = bound(nbytes, ops, F32_FLOPS)
    lib = "—" if library_ms is None else f"{library_ms:.4f} ms"
    log(f"[train-kernel] {label}: max|kernel-plain|={err:.3g} | kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib}, bound "
        f"{b_ms:.4f} ms ({b_by}), {nbytes / ms / 1e6:.1f} GB/s, "
        f"{100 * b_ms / ms:.1f} % of the bound{extra}")
    return dict(label=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=b_ms, bound_by=b_by,
                nbytes=nbytes)


def gram_note(gram_ops, x) -> str:
    """The Gram launch's plan for ``x`` and its kernel's ptxas figures."""
    n, d = x.shape[-2:]
    plan = gram_ops.launch_plan(x[..., 0, 0].numel(), n, d, x.data_ptr())
    name = (f"gram_reg_kernelILi{n}ELi{plan.vec}E" if plan.path == "register"
            else "gram_partial_kernel")
    return (f"; {plan.path} kernel, {4 * plan.vec}-byte loads, "
            f"{plan.n_chunks} chunks" + ptxas_note(name))


def train_kernel_phase(dev, D: int):
    """The five aggregation kernels of the training path against their
    plain versions at its shapes (quickstart: 9 workers pull 4 of 5 servers,
    5 servers take 7 of 9 gradients with f = 2; sync_filters: MeaMed over
    the 5 equivocated servers)."""
    from repro_torch.agg.rules import subset_masks
    from repro_torch.kernels.cwise_median import ops as order_ops
    from repro_torch.kernels.mda_diameter import ops as diam_ops
    from repro_torch.kernels.pairwise_sqdist import ops as gram_ops
    from repro_torch.kernels.pairwise_sqdist.ref import sqdists_from_gram
    rows: dict[str, list] = {"cwise_median": [], "cwise_trimmed_mean": [],
                             "cwise_meamed": [], "gram": [],
                             "subset_diameters": []}

    def stack(B, n, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        x = 0.05 * torch.randn((B, n, D), generator=g, device=dev)
        x[:, -1, ::97] = float("nan")        # Byzantine NaN coordinates
        return x

    def exact(got, want):
        torch.cuda.synchronize()
        err = (got - want).abs().nan_to_num(0.0).max().item()
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        return err

    # median: worker pulls [9, 4, D] and the DMC gather [5, 4, D]; exact
    for B, n, role in ((9, 4, "pull"), (5, 4, "DMC gather")):
        x = stack(B, n, B * n)
        err = exact(order_ops.cwise_median(x), order_ops.cwise_median_plain(x))
        rows["cwise_median"].append(_row(
            f"cwise_median {role} [{B}, {n}, {D}]", err,
            cold_ms(order_ops.cwise_median, (x,), 100),
            cold_ms(order_ops.cwise_median_plain, (x,), 20),
            cold_ms(lambda t: torch.quantile(t, 0.5, dim=1), (x,), 20),
            4.0 * (B * n * D + B * D), _bitonic_ops(n) * B * D))
    # trimmed mean: the gallery's servers [5, 7, D], f = 2; the same sorted
    # rows added in the same order and one IEEE division: exact
    x = stack(5, 7, 57)
    err = exact(order_ops.cwise_trimmed_mean(x, 2),
                order_ops.cwise_trimmed_mean_plain(x, 2))
    rows["cwise_trimmed_mean"].append(_row(
        f"cwise_trimmed_mean [5, 7, {D}] f=2", err,
        cold_ms(lambda t: order_ops.cwise_trimmed_mean(t, 2), (x,), 100),
        cold_ms(lambda t: order_ops.cwise_trimmed_mean_plain(t, 2), (x,), 20),
        None, 4.0 * (5 * 7 * D + 5 * D), (_bitonic_ops(7) + 3) * 5 * D))
    # MeaMed: sync_filters' equivocated refresh [5, 5, D], f = 1; exact
    x = stack(5, 5, 55)
    err = exact(order_ops.cwise_meamed(x, 1),
                order_ops.cwise_meamed_plain(x, 1))
    rows["cwise_meamed"].append(_row(
        f"cwise_meamed [5, 5, {D}] f=1", err,
        cold_ms(lambda t: order_ops.cwise_meamed(t, 1), (x,), 100),
        cold_ms(lambda t: order_ops.cwise_meamed_plain(t, 1), (x,), 20),
        None, 4.0 * (5 * 5 * D + 5 * D), (_bitonic_ops(5) + 30) * 5 * D))
    # Gram: MDA at the 5 servers over 7 gradients; float32 summation order,
    # so entries are held within 1e-5 of the squared norms bounding them
    g = torch.Generator(device=dev).manual_seed(7)
    x = 0.05 * torch.randn((5, 7, D), generator=g, device=dev)
    got, want = gram_ops.gram(x), gram_ops.gram_plain(x)
    torch.cuda.synchronize()
    sq = torch.diagonal(want, dim1=-2, dim2=-1)
    scale = sq[..., :, None] + sq[..., None, :]
    err = (got - want).abs().max().item()
    d2_err = (sqdists_from_gram(got) - sqdists_from_gram(want)).abs()
    if not (torch.all((got - want).abs() <= 1e-5 * scale)
            and torch.all(d2_err <= 1e-5 * scale)):
        raise AssertionError(f"gram kernel off its plain version by {err}")
    if not torch.equal(gram_ops.gram(x), got):
        raise AssertionError("gram kernel is not deterministic")
    rows["gram"].append(_row(
        f"gram [5, 7, {D}]", err,
        cold_ms(gram_ops.gram, (x,), 100),
        cold_ms(gram_ops.gram_plain, (x,), 20),
        cold_ms(lambda t: torch.bmm(t, t.transpose(1, 2)), (x,), 100),
        4.0 * (5 * 7 * D + 5 * 49), 2.0 * 5 * 28 * D,
        f", max|d2| err / scale {(d2_err / scale.clamp(min=1e-30)).max().item():.2g}"
        + gram_note(gram_ops, x)))
    # subset diameters: C(7, 5) = 21 subsets for each of the 5 servers; exact
    d2 = sqdists_from_gram(got)
    masks = subset_masks(7, 2)
    mask_t = torch.as_tensor(masks, device=dev)
    err = exact(diam_ops.subset_diameters(d2, masks),
                diam_ops.subset_diameters_plain(d2, mask_t))
    rows["subset_diameters"].append(_row(
        "subset_diameters [5, 7, 7] x 21 subsets", err,
        cold_ms(lambda t: diam_ops.subset_diameters(t, masks), (d2,), 200),
        cold_ms(lambda t: diam_ops.subset_diameters_plain(t, mask_t), (d2,),
                50),
        None, 4.0 * 5 * 49 + 8.0 * 21 + 4.0 * 5 * 21, 5.0 * 21 * 25))
    return rows


def _mixture_batches(rng, steps, n_w, batch, spec):
    centres = spec.sep * rng.standard_normal((spec.n_classes, spec.dim))
    y = rng.integers(0, spec.n_classes, (steps, n_w, batch))
    x = centres[y] + spec.noise * rng.standard_normal(y.shape + (spec.dim,))
    return (torch.from_numpy(x.astype(np.float32)),
            torch.from_numpy(y.astype(np.int64)))


def _quorum_tables(rng, cfg, steps):
    def pick(n_recv, n_send, q, self_first=False):
        rows = []
        for r in range(n_recv):
            others = [s for s in rng.permutation(n_send)
                      if not (self_first and s == r)]
            rows.append(([r] if self_first else []) + others)
        return np.asarray(rows)[:, :q]

    pull = np.stack([pick(cfg.n_workers, cfg.n_servers, cfg.q_servers)
                     for _ in range(steps)])
    push = np.stack([pick(cfg.n_servers, cfg.n_workers, cfg.q_workers)
                     for _ in range(steps)])
    gather = np.stack([pick(cfg.n_servers, cfg.n_servers, cfg.q_servers,
                            True) for _ in range(steps // cfg.T)])
    return pull, push, gather


def train_reference_phase(dev):
    """quickstart at mlp_h1024 for 2T + 3 steps on shared quorum tables and
    numpy batches: the card's kernels against the CPU's plain versions."""
    import dataclasses

    from repro_torch.agg import registry
    from repro_torch.core.quorum import TraceDelivery
    from repro_torch.exp import presets
    e = presets.get("quickstart", model=TRAIN_MODEL, steps=REF_STEPS)
    cfg = e.to_config()
    rng = np.random.default_rng(SEED)
    tables = _quorum_tables(rng, cfg, REF_STEPS)
    x, y = _mixture_batches(rng, REF_STEPS, cfg.n_workers, e.batch,
                            e.mixture)
    init, _, _ = e.build_problem()
    mda = registry.get("mda")
    out, sels = {}, {}
    for key, d in (("cpu", torch.device("cpu")), ("card", dev)):
        sim = e.build_sim(TraceDelivery(*tables, T=cfg.T, device=d), d)
        flat0 = sim.tree.flatten(init(torch.Generator().manual_seed(SEED)))
        state = sim.state_from(flat0, torch.Generator(d).manual_seed(1))
        picked = sels[key] = []

        def record(d2, f, **kw):
            w = mda.weights_from_d2(d2, f, **kw)
            picked.append((w > 0).cpu())
            return w

        registry._REGISTRY["mda"] = dataclasses.replace(
            mda, weights_from_d2=record)
        try:
            t0 = time.perf_counter()
            state, _ = sim.run(state, [(x[i].to(d), y[i].to(d))
                                       for i in range(REF_STEPS)])
            params = state.params.cpu()
            wall = time.perf_counter() - t0
        finally:
            registry._REGISTRY["mda"] = mda
        out[key] = params
        log(f"[train-ref] {key}: {REF_STEPS} steps in {wall:.1f} s")
    if not torch.isfinite(out["card"]).all():
        raise AssertionError("non-finite params on the card")
    same = (len(sels["cpu"]) == len(sels["card"]) == REF_STEPS
            and all(torch.equal(a, b) for a, b in zip(sels["cpu"],
                                                      sels["card"])))
    err = (out["card"] - out["cpu"]).abs().max().item()
    log(f"[train-ref] quickstart {TRAIN_MODEL} (D = {out['cpu'].shape[1]}), "
        f"{REF_STEPS} steps, 2 gathers: card kernels vs CPU plain versions "
        f"max|params diff|={err:.3g} (max|param| "
        f"{out['cpu'].abs().max().item():.3g}); every MDA selection matched "
        f"({REF_STEPS} steps x {cfg.n_servers} servers): {same}")
    if not same:
        raise AssertionError("an MDA selection differs between the card and "
                             "the CPU")
    # float32 sums in other orders (cuBLAS vs the CPU's GEMMs, the Gram
    # kernel's chunks), carried through 23 steps of training
    torch.testing.assert_close(out["card"], out["cpu"], rtol=1e-3, atol=1e-4)
    return err


TRAIN_RUNS = (
    ("quickstart", dict(model=TRAIN_MODEL, steps=150),
     ("gram", "subset_diameters", "cwise_median")),
    ("sync_filters", dict(model=TRAIN_MODEL, steps=100), ("cwise_meamed",)),
    ("attack_gallery", dict(model=TRAIN_MODEL, data="mixture10_easy",
                            steps=120, batch=25, gar="trimmed_mean"),
     ("cwise_trimmed_mean",)),
)


def _counters():
    from repro_torch.kernels.cwise_median import ops as order_ops
    from repro_torch.kernels.mda_diameter import ops as diam_ops
    from repro_torch.kernels.pairwise_sqdist import ops as gram_ops
    return {"cwise_median": order_ops.cwise_median,
            "cwise_trimmed_mean": order_ops.cwise_trimmed_mean,
            "cwise_meamed": order_ops.cwise_meamed, "gram": gram_ops.gram,
            "subset_diameters": diam_ops.subset_diameters}


def train_phase(dev):
    """The three fused training runs; each kernel's launches counted from 0
    around the run that drives it."""
    from repro_torch import exp
    from repro_torch.core.attacks import ByzantineSpec
    counters = _counters()
    launches = {k: 0 for k in counters}
    results = {}
    for name, kw, needs in TRAIN_RUNS:
        if name == "attack_gallery":
            spec = exp.Experiment(name=name, byz=ByzantineSpec(
                worker_attack="alie", n_byz_workers=2, equivocate=True), **kw)
        else:
            spec = exp.get(name, **kw)
        torch.cuda.reset_peak_memory_stats(dev)
        for c in counters.values():
            c.launches = 0
        res = exp.run(spec, device=dev)
        torch.cuda.synchronize()
        got = {k: c.launches for k, c in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        acc = res.final["acc"]
        log(f"[train] {name} ({spec.variant}, gar {spec.gar}, "
            f"{spec.n_workers}/{spec.f_workers} workers, "
            f"{spec.n_servers}/{spec.f_servers} servers, T={spec.T}, "
            f"{spec.steps} steps, {TRAIN_MODEL}): {spec.steps / res.wall_s:.2f}"
            f" steps/s ({res.wall_s:.2f} s), final acc {acc:.4f}, peak "
            f"device memory {peak_gb:.2f} GB, launches {got}"
            + (f", final rejects {res.final['rejects']}"
               if "rejects" in res.final else ""))
        log(f"[train] {name} acc log " + json.dumps(
            [(m["step"], round(m["acc"], 4)) for m in res.logs]))
        if not np.isfinite(acc) or acc <= 0.2:
            raise AssertionError(f"{name}: final accuracy {acc} is not "
                                 f"finite and above 0.2 (twice chance)")
        for k in needs:
            if got[k] <= 0:
                raise AssertionError(f"{k} kernel was not launched by the "
                                     f"{name} run")
        for k in launches:
            launches[k] += got[k]
        results[name] = dict(steps_s=spec.steps / res.wall_s, acc=acc,
                             peak_gb=peak_gb, launches=got)
    _profile(f"quickstart {TRAIN_MODEL}, 20 fused steps",
             lambda: exp.run("quickstart", device=dev, model=TRAIN_MODEL,
                             steps=20))
    return launches, results


# ---------------------------------------------------------------------------
# the zoo training slice: flash backward, protocol reference, protocol train
# ---------------------------------------------------------------------------

def sdpa_bwd_ms(q, k, v, do, lib: dict) -> float:
    """Device time of the backward of ``F.scaled_dot_product_attention`` on
    these inputs, timed as the kernels are (:func:`cold_ms`, graph replay,
    cold L2): the forward and backward together, less the forward alone.
    The backward runs on the stream of its forward, so capturing both in
    one graph captures the backward too."""
    def fwd(q, k, v, do):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        return leaves, F.scaled_dot_product_attention(*leaves,
                                                      enable_gqa=True, **lib)

    def fwd_bwd(q, k, v, do):
        leaves, out = fwd(q, k, v, do)
        return torch.autograd.grad(out, leaves, do)

    args = tuple(t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    return cold_ms(fwd_bwd, args, 10) - cold_ms(fwd, args, 10)


BWD_CASES = (
    # label, B, Sq, Skv, H, kvH, hd, window, dtype
    ("protocol shape", 4, 1024, 1024, 24, 8, 128, 0, torch.bfloat16),
    ("ragged windowed GQA", 2, 1000, 1000, 24, 8, 128, 256, torch.bfloat16),
    ("padded hd 32", 4, 64, 64, 4, 2, 32, 0, torch.float32),
)


def flash_bwd_phase(dev):
    """The dq and dkv kernels against the plain backward, timed."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_bwd_from_delta, flash_delta)
    rows = {"flash_bwd_dq": [], "flash_bwd_dkv": []}
    for label, B, Sq, Skv, H, kvH, hd, window, dt in BWD_CASES:
        g = torch.Generator(device=dev).manual_seed(Sq + hd + window)
        q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dt)
        k = torch.randn((B, Skv, kvH, hd), generator=g, device=dev).to(dt)
        v = torch.randn((B, Skv, kvH, hd), generator=g, device=dev).to(dt)
        do = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dt)
        o, lse = ops.flash_attention(q, k, v, causal=True, window=window)
        got = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                      window=window)
        again = ops.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                        window=window)
        delta = flash_delta(o, do).contiguous()
        want = flash_bwd_from_delta(q, k, v, do, lse, delta, causal=True,
                                    window=window)
        torch.cuda.synchronize()
        # both sides accumulate in float32 and round once at the output:
        # bf16 outputs may differ by one rounding step (2^-7 of the value),
        # float32 ones by summation order
        rtol, atol = (1e-4, 1e-5) if dt == torch.float32 else (2 ** -7, 1e-3)
        errs = [(a.float() - w.float()).abs().max().item()
                for a, w in zip(got, want)]
        typical = [w.float().abs().median().item() for w in want]
        for a, w in zip(got, want):
            torch.testing.assert_close(a.float(), w.float(), rtol=rtol,
                                       atol=atol)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        if not same:
            raise AssertionError(f"flash backward ({label}) is not "
                                 "deterministic")
        # the kernels' own operands: hd padded to 128, contiguous
        pad = (lambda t: t if hd == 128 else F.pad(t, (0, 128 - hd)))
        qp, kp, vp, dop = (pad(t).contiguous() for t in (q, k, v, do))
        kw = dict(scale=hd ** -0.5, causal=True, window=window)
        dq_ms = cold_ms(lambda *t: ops.flash_bwd_dq(*t, **kw),
                        (qp, kp, vp, dop, lse, delta), 10)
        dkv_ms = cold_ms(lambda *t: ops.flash_bwd_dkv(*t, **kw),
                         (qp, kp, vp, dop, lse, delta), 10)
        plain_ms = cold_ms(lambda *t: flash_bwd_from_delta(
            *t, causal=True, window=window), (q, k, v, do, lse, delta), 3)
        # the library's backward of the same attention (dq, dk, dv at once)
        if window:
            i = torch.arange(Sq, device=dev)
            lib = dict(attn_mask=(i[None] <= i[:, None])
                       & (i[None] > i[:, None] - window))
        else:
            lib = dict(is_causal=True)
        library_ms = sdpa_bwd_ms(q, k, v, do, lib)
        # the work these inputs need: visible (q, k) pairs, the true hd
        i = np.arange(Sq)
        lo = np.maximum(0, i - window + 1) if window else 0
        pairs = int(np.sum(i + 1 - lo)) * B * H
        es = torch.finfo(dt).bits // 8
        qb, kvb = es * B * Sq * H * hd, es * B * Skv * kvH * hd
        vec = 4.0 * B * H * Sq                           # lse or delta
        for name, ms, n_prod, nbytes in (
                ("flash_bwd_dq", dq_ms, 3, 4 * qb + 2 * kvb + 2 * vec),
                ("flash_bwd_dkv", dkv_ms, 4, 2 * qb + 4 * kvb + 2 * vec)):
            flops = 2.0 * hd * pairs * n_prod
            b_ms, b_by = bound(nbytes, flops,
                               BF16_FLOPS if dt == torch.bfloat16
                               else F32_FLOPS)
            rows[name].append(dict(label=label, max_abs_err=max(errs), ms=ms,
                                   plain_ms=plain_ms, library_ms=library_ms,
                                   bound_ms=b_ms, bound_by=b_by, flops=flops))
            log(f"[bwd-kernel] {name} {label} [B {B}, S {Sq}/{Skv}, heads "
                f"{H}/{kvH}, hd {hd}, window {window}, {str(dt)[6:]}]: "
                f"max|dq,dk,dv - plain| {errs[0]:.3g}/{errs[1]:.3g}/"
                f"{errs[2]:.3g} (tol {atol} + {rtol:.3g} x |plain|; median "
                f"|plain| {typical[0]:.3g}/{typical[1]:.3g}/"
                f"{typical[2]:.3g}), two launches bit-equal {same} | "
                f"kernel {ms:.4f} ms, plain (whole backward) {plain_ms:.4f} "
                f"ms, sdpa backward {library_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}), {flops / ms / 1e9:.1f} TFLOP/s, "
                f"{100 * b_ms / ms:.1f} % of the bound")
    return rows


def _token_tables(rng, G, q_w, q_ps, T, steps):
    def pick(q, self_first=False):
        rows = []
        for r in range(G):
            others = [s for s in rng.permutation(G)
                      if not (self_first and s == r)]
            rows.append(([r] if self_first else []) + others)
        return np.asarray(rows)[:, :q]
    return (np.stack([pick(q_ps) for _ in range(steps)]),
            np.stack([pick(q_w) for _ in range(steps)]),
            np.stack([pick(q_ps, True) for _ in range(steps // T)]))


def protocol_reference_phase(dev):
    """lm/tfm_tiny (f32) through the ProtocolEngine: card vs CPU."""
    import dataclasses

    from repro_torch.agg import registry
    from repro_torch.core import protocol
    from repro_torch.core.attacks import ByzantineSpec
    from repro_torch.core.quorum import TraceDelivery
    from repro_torch.exp import presets
    from repro_torch.models.registry import get_bundle
    e = presets.get("lm/tfm_tiny")
    pcfg = dataclasses.replace(e.to_protocol_config(), byz=ByzantineSpec(
        worker_attack="alie", n_byz_workers=1))
    T, G = pcfg.T, pcfg.n_groups
    steps = 2 * T + 1
    bundle = get_bundle("phi4-mini-3.8b", reduced=True, act_dtype="float32")
    rng = np.random.default_rng(SEED)
    tables = _token_tables(rng, G, pcfg.q_workers, pcfg.q_servers, T, steps)
    spec = e.to_dict()
    toks = rng.integers(0, bundle.cfg.vocab,
                        (steps, G, spec["batch"], 65))
    batches = {"tokens": torch.from_numpy(toks[..., :-1]),
               "labels": torch.from_numpy(toks[..., 1:])}
    init = protocol.make_init_fn(bundle, pcfg, "cpu")(SEED)
    mda = registry.get("mda")
    out, sels = {}, {}
    for key, d in (("cpu", torch.device("cpu")), ("card", dev)):
        eng = protocol.ProtocolEngine(
            bundle, pcfg, e.build_schedule(), with_attack=True,
            delivery=TraceDelivery(*tables, T=T, device=d), device=d)
        state = init._replace(params=init.params.clone().to(d),
                              gen=torch.Generator(d).manual_seed(1))
        picked = sels[key] = []

        def record(d2, f, **kw):
            w = mda.weights_from_d2(d2, f, **kw)
            picked.append((w > 0).cpu())
            return w

        registry._REGISTRY["mda"] = dataclasses.replace(
            mda, weights_from_d2=record)
        try:
            t0 = time.perf_counter()
            state, _ = eng.run(state, {k: v.to(d) for k, v in
                                       batches.items()})
            out[key] = state.params.cpu()
            wall = time.perf_counter() - t0
        finally:
            registry._REGISTRY["mda"] = mda
        log(f"[protocol-ref] {key}: {steps} steps in {wall:.1f} s")
    if not torch.isfinite(out["card"]).all():
        raise AssertionError("non-finite params on the card")
    same = (len(sels["cpu"]) == len(sels["card"]) == steps
            and all(torch.equal(a, b) for a, b in zip(sels["cpu"],
                                                      sels["card"])))
    err = (out["card"] - out["cpu"]).abs().max().item()
    log(f"[protocol-ref] lm/tfm_tiny f32 (P = {out['cpu'].shape[1]}, G = "
        f"{G}, ALIE x1), {steps} steps, 2 gathers: card kernels vs CPU plain "
        f"versions max|params diff|={err:.3g} (max|param| "
        f"{out['cpu'].abs().max().item():.3g}); every MDA selection matched "
        f"({steps} steps x {G} servers): {same}")
    if not same:
        raise AssertionError("an MDA selection differs between the card and "
                             "the CPU")
    # float32 sums in other orders (cuBLAS, the flash kernels' tiles, the
    # Gram kernel's chunks), carried through 11 steps of training
    torch.testing.assert_close(out["card"], out["cpu"], rtol=1e-3, atol=1e-4)
    return err


PROTO_STEPS = 11
# sgd with inverse_linear(0.002, 0.005): the JAX launcher's lr0 of 0.02 suits
# its reduced (d_model 128) model; at the full width of 3072 one step of it
# overshoots, and the loss rises instead of falling
PROTO_ARGV = ["--arch", "phi4-mini-3.8b", "--depth", "2", "--groups", "4",
              "--T", "5", "--seq", "1024", "--batch-per-group", "4",
              "--steps", str(PROTO_STEPS), "--lr", "0.002", "--worker-attack",
              "alie", "--n-byz", "1", "--log-every", "1"]


def _proto_counters():
    from repro_torch.kernels.flash_attention import ops as flash_ops
    c = _counters()
    c.update({"flash_attention": flash_ops.flash_attention,
              "flash_bwd_dq": flash_ops.flash_bwd_dq,
              "flash_bwd_dkv": flash_ops.flash_bwd_dkv})
    return c


def protocol_kernel_rows(dev, G: int, P: int, chunk_bytes: int):
    """The Gram and median kernels at the protocol run's shapes: MDA's one
    Gram over the ``[G, P]`` gradient stack, the masked pull's and the DMC
    gather's streamed chunk ``[G, G, c]`` (every server in each quorum at
    f_ps = 0) and ``consolidate``'s chunk ``[G, c]``. A seeded stack of
    that size stands in for the gradients."""
    from repro_torch.kernels.cwise_median import ops as order_ops
    from repro_torch.kernels.pairwise_sqdist import ops as gram_ops
    from repro_torch.kernels.pairwise_sqdist.ref import sqdists_from_gram
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    x = 0.05 * torch.randn((G, P), generator=g, device=dev)
    got, again = gram_ops.gram(x), gram_ops.gram(x)
    want = gram_ops.gram_plain(x)
    exact = torch.zeros((G, G), dtype=torch.float64, device=dev)
    for c0 in range(0, P, 2**26):
        xc = x[:, c0:c0 + 2**26].double()
        exact += xc @ xc.T
    del xc
    torch.cuda.synchronize()
    sq = torch.diagonal(exact)
    scale = sq[:, None] + sq[None, :]
    d2 = sqdists_from_gram(got).double()
    errs = {name: ((got.double() - ref).abs() / scale).max().item()
            for name, ref in (("plain", want.double()), ("float64", exact))}
    errs["d2 float64"] = ((d2 - sqdists_from_gram(exact)).abs()
                          / scale).max().item()
    same = torch.equal(got, again)
    log(f"[protocol-kernel] gram [{G}, {P}]: {gram_ops.chunking(1, P)[1]} "
        f"chunks; max|kernel - ref| / (|xi|^2 + |xj|^2): "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (tol 1e-5); two launches bit-equal {same}")
    if not same or max(errs.values()) > 1e-5:
        raise AssertionError(f"gram kernel at [{G}, {P}]: {errs}, "
                             f"bit-equal {same}")
    rows = {"gram": [_row(
        f"protocol gram [{G}, {P}]", (got - want).abs().max().item(),
        cold_ms(gram_ops.gram, (x,), 3), cold_ms(gram_ops.gram_plain, (x,), 2),
        cold_ms(lambda t: t @ t.T, (x,), 3),
        4.0 * (G * P + G * G), 2.0 * (G * (G + 1) // 2) * P,
        gram_note(gram_ops, x))]}
    del want
    # the pull's and the gather's chunk (masked_pull), consolidate's chunk
    rows["cwise_median"] = []
    c = chunk_bytes // (G * G * 4)
    perm = torch.stack([torch.roll(torch.arange(G, device=dev), -r)
                        for r in range(G)])
    for label, t in ((f"protocol pull/gather chunk [{G}, {G}, {c}]",
                      x[:, :c][perm]),
                     (f"protocol consolidate chunk [{G}, {4 * c}]",
                      x[:, :4 * c].contiguous())):
        got_m = order_ops.cwise_median(t)
        want_m = order_ops.cwise_median_plain(t)
        torch.cuda.synchronize()
        torch.testing.assert_close(got_m, want_m, rtol=0, atol=0)
        n, cols = t.shape[-2], t.shape[-1]
        batch = t.numel() // (n * cols)
        rows["cwise_median"].append(_row(
            label, (got_m - want_m).abs().max().item(),
            cold_ms(order_ops.cwise_median, (t,), 20),
            cold_ms(order_ops.cwise_median_plain, (t,), 5),
            cold_ms(lambda u: torch.quantile(u, 0.5, dim=-2), (t,), 5),
            4.0 * (t.numel() + batch * cols), _bitonic_ops(n) * batch * cols))
    return rows


def protocol_train_phase(dev):
    """phi4-mini-3.8b at full width, depth 2, G = 4, through the training
    launcher (``launch/train.py``); launches counted from 0 around the
    run."""
    from repro_torch import exp
    from repro_torch.core.protocol import ProtocolConfig
    from repro_torch.data.pipeline import token_stream
    from repro_torch.launch import train
    counters = _proto_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    run = train.main(PROTO_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: c.launches for k, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    losses = [loss for _, loss in run.losses]
    warm = run.step_s[1:]
    log(f"[protocol] phi4-mini-3.8b depth 2 full width (P = "
        f"{run.n_params:,}), G = 4, f_w = 1 (ALIE x1), T = 5, "
        f"{PROTO_STEPS} steps of 4 x 1024 tokens per group: "
        f"{PROTO_STEPS / sum(run.step_s):.3f} steps/s over all steps, "
        f"{len(warm) / sum(warm):.3f} steps/s after the first "
        f"(first {run.step_s[0]:.2f} s, then {np.mean(warm):.3f} s each), "
        f"train.main wall {wall:.1f} s, peak device memory {peak_gb:.1f} GB")
    log("[protocol] loss per step " + json.dumps(
        [(i, round(x, 4)) for i, x in run.losses]))
    log("[protocol] launches " + json.dumps(got) + " | per step "
        + json.dumps({k: round(v / PROTO_STEPS, 2) for k, v in got.items()}))
    if not np.all(np.isfinite(losses)) or len(losses) != PROTO_STEPS:
        raise AssertionError(f"protocol losses not finite: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"protocol loss did not fall: {losses}")
    if peak_gb >= 80:
        raise AssertionError(f"peak device memory {peak_gb:.1f} GB")
    for k in ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv", "gram",
              "subset_diameters", "cwise_median"):
        if got[k] < PROTO_STEPS:
            raise AssertionError(f"{k} was launched {got[k]} times in "
                                 f"{PROTO_STEPS} protocol steps")
    extra = list(token_stream(SEED + 1, run.bundle.cfg.vocab, 4, 4, 1024, 2,
                              device=dev))
    state = run.state

    def two_steps():
        nonlocal state
        for b in extra:
            state = run.step(state, b)

    busy = _profile("protocol phi4-mini-3.8b depth 2, 2 steps", two_steps)
    G, P = run.state.params.shape
    del run, state, extra
    gc.collect()
    torch.cuda.empty_cache()
    rows = protocol_kernel_rows(dev, G, P, ProtocolConfig.chunk_bytes)
    gc.collect()
    torch.cuda.empty_cache()
    res = exp.run("lm/tfm_tiny", device=dev)
    torch.cuda.synchronize()
    log(f"[protocol] exp.run('lm/tfm_tiny') on the card: {res.summary()}; "
        f"acc (negative eval loss) log "
        + json.dumps([(m["step"], round(m["acc"], 4)) for m in res.logs]))
    if not np.isfinite(res.final["acc"]):
        raise AssertionError("lm/tfm_tiny: non-finite eval loss")
    return got, rows, dict(peak_gb=peak_gb, busy=busy)



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
        for fn, (regs, st, ld) in _build.ptxas_usage(text).items():
            log(f"[build] {name}: {fn}: {regs} registers, spill {st} B "
                f"stores / {ld} B loads")
            PTXAS[fn] = (regs, st, ld)
        for line in text.splitlines():
            if re.search(r"\(C\d+\)", line):   # ptxas advice, e.g. C7519
                log(f"[build] {name}: {line.strip()[:300]}")

    with torch.inference_mode():
        flash = flash_phase(dev)
        median = median_phase(dev)
        reference_phase(dev)
        launches, _ = serve_phase(dev)
        train_rows = train_kernel_phase(dev, D_MLP_H1024)
    # the serving replicas are gone with serve_phase's frame: hand their
    # memory back before the training phases
    gc.collect()
    torch.cuda.empty_cache()
    # the training phases need autograd: outside inference mode
    train_reference_phase(dev)
    train_launches, _ = train_phase(dev)
    launches["cwise_median"] += train_launches["cwise_median"]
    launches.update({k: v for k, v in train_launches.items()
                     if k != "cwise_median"})
    bwd_rows = flash_bwd_phase(dev)
    protocol_reference_phase(dev)
    proto_launches, proto_rows, _ = protocol_train_phase(dev)
    for k, v in proto_launches.items():
        launches[k] = launches.get(k, 0) + v

    rows = dict(train_rows)
    rows.update(bwd_rows)
    rows["flash_attention"] = flash
    rows["cwise_median"] = [dict(r, nbytes=4.0 * (r["n"] + 1) * N_SLOTS
                                 * 200064) for r in median] \
        + train_rows["cwise_median"] + proto_rows["cwise_median"]
    rows["gram"] = train_rows["gram"] + proto_rows["gram"]
    kernels = []
    for name, src, replaces in (
            ("flash_attention", "flash_attention/csrc/flash_fwd.cu",
             "flash_attention/kernel.py:28"),
            ("cwise_median", "cwise_median/csrc/cwise_median.cu",
             "cwise_median/kernel.py:54"),
            ("cwise_trimmed_mean", "cwise_median/csrc/cwise_median.cu",
             "cwise_median/kernel.py:60"),
            ("cwise_meamed", "cwise_median/csrc/cwise_median.cu",
             "cwise_median/kernel.py:69"),
            ("gram", "pairwise_sqdist/csrc/gram.cu",
             "pairwise_sqdist/kernel.py:24"),
            ("subset_diameters", "mda_diameter/csrc/mda_diameter.cu",
             "mda_diameter/kernel.py:17"),
            ("flash_bwd_dq", "flash_attention/csrc/flash_bwd.cu",
             "flash_attention/kernel.py:135"),
            ("flash_bwd_dkv", "flash_attention/csrc/flash_bwd.cu",
             "flash_attention/kernel.py:164")):
        rs = rows[name]
        # the row of the path's largest call (flash forward and backward:
        # the protocol run's shape)
        main_row = (max(rs, key=lambda r: (r["S"], -r["window"]))
                    if name == "flash_attention"
                    else max(rs, key=lambda r: r["flops"])
                    if name.startswith("flash_bwd")
                    else max(rs, key=lambda r: r["nbytes"]))
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{src}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
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

#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   CUDA kernels from ``src/repro_torch/kernels/*/csrc`` (one ``nvcc`` per
   source, all at once); then counts the device work of one exact MDA
   selection on the kernel's route (one launch, no copy) and on the route
   it replaced, with ``torch.profiler``, before any CUDA graph runs.
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
   Gram and the exact MDA selection against their plain versions at the
   training path's shapes (the ``mlp_h1024`` model, D = 1,093,642; the
   selection also at the protocol's ``[4, 3, 3]`` and at S = 125,970), timed
   as in 2; for the selection also the host wall of one whole selection, in
   turns with the route it replaced, and an empty kernel's time. The build
   prints each MeaMed instance's ``ptxas`` stack frame (none allowed) and
   SASS instruction count.
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
11. Netsim phase: the realized ``crash_storm`` trace of
   ``repro_torch.netsim`` (9/2 workers, 5/1 servers, T = 5, the payload of
   ``mlp_h1024``), whose starved quorums repeat a sender (the count of such
   rows is printed, and must not be 0): its first 23 steps through the
   stepwise simulator at ``mlp_h1024`` on the card and on the CPU, params
   within the stated tolerance and every MDA selection the same, exact ties
   included. Then ``netsim/byzantine_plus_slow`` at ``mlp_h1024`` for 150
   fused steps over its trace (steps/s, virtual ms, shortfalls, mean pull
   staleness, final accuracy above 0.2, peak memory, kernel launches, a
   profiler window), and ``lm/tfm_tiny`` through the protocol over the
   ``membership_churn`` trace at G = 5 (finite losses).
12. Checkpoint and elastic phase. (a) Right after phase 10, on its last
   state (13 steps: its profiled two included; phi4-mini-3.8b, full width, depth 2, G = 4, f32 replicas: 13.05
   GB of params): the free disk, then one save with the port's
   checkpointer (bytes, seconds), ``ReplicaPool.from_checkpoint`` onto the
   card (seconds; every leaf bit-equal to the live state), 8 requests
   (prompts of 64-1024 tokens, 16 new tokens) through
   ``QuorumService(median, f=1, n_slots=4)`` over the restored pool,
   token-identical to the same service over the live state, with the flash
   forward and the median launched; the same with replica 3 corrupted
   (``reversed``: disagreement and ejections reported, not gated);
   ``restore_consolidated`` on the card, cast to bf16, prefill and decode
   (finite logits); the directory is removed. (b) After phase 11:
   ``launch.train --reduced`` 12 steps with ``--ckpt-every 5`` against 7
   steps, killed, and resumed to 12 (bit-equal, t = 12), then
   ``launch.serve --ckpt-dir --quorum`` on that checkpoint. (c)
   ``elastic/static`` bit-identical to ``runner="protocol"``;
   ``elastic/planned_churn`` at ``mlp_h1024`` (G 5 -> 4 -> 5, 24 steps)
   uninterrupted and killed at step 12 and resumed, bit-identical (steps/s,
   final accuracy above 0.2, peak memory, the median launches of the
   joiner's seeding, every MDA selection kept for phase 20);
   ``elastic/netsim_churn`` finite.
13. The zoo: the MoE and RWKV6 families. (a) The flash forward at
   qwen3-moe's heads (``[1, 1024, 64/4, 64]``, bf16, causal) against its
   plain version, timed as in 2; the WKV scan's chunk-recurrence kernels
   (forward and backward, decays in (0, 1]) against the plain loops at
   rwkv6-4k's ``[256, 4, 40, 64, 64]`` and at V = 8, within N roundings of
   the chain's largest value (N + V for ``d_decay``), two launches
   bit-equal, each timed as in 2 beside its bound by bytes and the loop
   with autograd it replaced. (b) qwen3-moe-235b-a22b at full width,
   depth 2 of 94 (four bf16 replicas of the full depth would not fit one
   card), random bf16 weights, phase 4's quorum run (4 replicas, replica 3
   ``reversed``, f = 1, 4 slots, 8 requests of 64-1024 prompt tokens, 16
   new tokens): token-identical to an honest single replica, every request
   equal to its own B = 1 prefill and decode (each slot routes alone), the
   flash forward and the median launched; tok/s, the R = 1 ratio, peak
   memory and a profiler window. (c) rwkv6-3b at full width, depth 2,
   through ``launch/train.py`` with phase 10's argv: finite, falling
   losses, peak memory under 80 GB, the median, the Gram, the selection
   and the WKV scan's two kernels launched at least once a step; steps/s,
   and a two-step
   profiler window with the WKV scan's share (its ranges, and the backward
   nodes of the ops they ran). (d) rwkv6-3b at full width, depth 8 of 32,
   with (b)'s requests and gates (no attention: the median and the WKV
   scan's forward); 8
   requests over 4 slots refill every slot, so the per-request check holds
   the state reset. (e) ``lm/moe_tiny`` and ``lm/rwkv_tiny`` in float32
   (activations and replicas) as phase 9, card against CPU, every MDA
   selection equal; then both presets as registered on the card.
14. The rest of the zoo: the vlm, hybrid and audio families. (a) The flash
   forward at whisper-small's encoder (``[4, 1500, 12/12, 64]``) and cross-
   attention (Sq 1024 over Skv 1500), both non-causal, at zamba2's shared
   block (``[4, 1024, 32/32, 64]``) and qwen2-vl's GQA-7
   (``[4, 1024, 28/4, 128]``), causal; dq and dkv at whisper's encoder
   shape and qwen2-vl's; each against its plain version, timed as in 2 and
   8. (b) qwen2-vl-7b at full width and depth through ``launch/serve.py``:
   a 4 x 1024 prefill of merged embeddings at ``[3, B, S]`` M-RoPE ids and
   32 decode steps; finite logits, the flash forward launched, peak memory
   under 80 GB; tok/s and a profiler window's busy share. (c) zamba2-1.2b
   at full width, depth 12 of 38, with phase 13 (b)'s quorum run and gates (the
   median and the flash forward launched; every request equal to its own
   B = 1 run, which holds the Mamba2 state reset). (d) zamba2-1.2b at full
   width, depth 12 (two shared-attention sites) through ``launch/train.py``
   with phase 10's argv: finite, falling losses, peak memory, the flash
   forward and backward, the median, the Gram and the selection launched
   each step; steps/s and the SSD scan's share of a two-step window. (e)
   whisper-small at full width and depth: serving over 1500 frames (a
   64-token prompt, 32 decode steps; the cross-attention's flash forward
   at Sq = 1 launched each layer each step), then ``launch/serve.py --arch
   whisper-small``; training: 4 protocol steps at G = 4 through
   ``ProtocolEngine.run`` on numpy frame and Zipf token batches (4 x 1024
   each), falling loss on a fixed batch, the non-causal flash backward
   launched. (f) The three families reduced in float32, card against CPU:
   loss and gradients, prefill and 3 decode steps; zamba2 through the
   protocol for 2T + 1 steps, every MDA selection equal.

15. The protocol over ``torch.distributed`` ranks (rows 1-4, 7 and 8 on
   every rank). (a) Phase 10's argv through ``launch/train.py`` on a
   world-1 NCCL group (the (1, 1, 1) mesh): params bit-equal to phase 10's
   after its 11 steps, or else within 1e-3 with every MDA selection equal
   (it says which). (b) phi4-mini-3.8b at full width, depth 2, G = 4 on 2
   ranks sharing the card over gloo (mesh (2, 1, 1), ``--mesh 2x1``), 1
   step (3 before phase 16, 2 before phase 18 took their share of the
   time limit): the per-rank memory reckoned from phase 10's peak first (the
   tokens a group cut to 2 x 1024 if 2 ranks would pass 72 GB); finite
   losses; per rank the peak memory, steps/s, bytes sent a step by tag
   (pull + aggregate within 10 % of ``collective_volume_bytes(rep=2)``)
   and the launches of each kernel (at least one a step). (c)
   ``lm/tfm_tiny`` as phase 9 on 4 ranks (rep 4) on the card against the
   single-card CPU run: every MDA selection equal, params within phase
   9's tolerance. Each rank is a process spawned by
   ``torch.multiprocessing``; one that fails fails the script.
16. The 'model' axis (tensor parallelism) over ranks sharing the card
   over gloo (rows 1-4, 7 and 8 on the model-split ranks). (a)
   phi4-mini-3.8b at full width and depth, random bf16 weights, through
   ``launch/serve.py --mesh 1x2``: the prefill logits against the single
   card's within rel-L2 2e-2 (beside bf16's own spread: the single card
   with float32 activations), then phase 4's quorum run at
   model 2 (4 replicas, replica 3 ``reversed``; 4 requests x 8 new
   tokens, ``TP_REQUESTS``, ``TP_NEW``): token-identical to the
   honest replica on the same mesh, replica 3 ejected, the flash forward
   and the median launched on each rank, each rank's peak memory. (b)
   phi4-mini-3.8b at full width, G = 4, through ``launch/train.py --mesh
   4x2`` (8 ranks: rep 4, model 2); its depth, steps and tokens reckoned
   first from the bytes a rank moves a step and the ranks' memory (a
   rank's step peak from the dry run, ``_rank_peak``), and printed:
   finite, falling losses, each step's pull + aggregate equal to
   ``collective_volume_bytes`` on the rank's blocks and the 'model' tags
   to ``model_volume_bytes``, rows 1-4, 7 and 8 launched each step. (c)
   ``lm/tfm_tiny`` at (rep 4, fsdp 1, model 2) on the same 8 ranks
   against the single-card CPU run (phase 15 (c)'s): every MDA selection
   equal.
17. The 'model' axis of the MoE, hybrid, RWKV6 and audio families
   (``tp_zoo_phase``), after 16.
18. The dry run (``repro_torch.launch.dryrun.measure``) held against the
   card. (a) Right after phase 12 (a), phase 10's protocol step on its
   state, measured by the same counter on meta and on the card: FLOPs
   equal, the dry run's peak within 15 % of ``max_memory_allocated``
   over the step (less what else was resident beside its arguments);
   then the step timed without the counter beside the roofline's
   estimate. (b) ``launch/steps.build_prefill_cell`` (phi4-mini-3.8b, 4
   x 1024, full depth) on a 1-rank mesh, on meta and on the card, held
   to (a)'s gates. (c) Each of phase 16 (b)'s 8 ranks dry-run on a
   ``RankView`` of the (4, 1, 2) mesh: its bytes by tag equal to its
   ``Mesh.sent`` of the run's first step; its dry-run peak beside its
   measured one. (d) phi4-mini-3.8b x ``train_4k`` on the 16 x 16
   production mesh, dry-run for its fullest rank and printed as a
   roofline row (reckoned, H100 SXM published peaks) with the host's
   seconds.
19. The port's static analyzer on the card (``python -m
   repro_torch.analyze --card``, layer 3), run first, right after the
   build (before any CUDA graph: the profiler was seen to drop records
   after graph replays): on the ``smoke`` preset, the device->host copies
   of one ``run()`` of the fused engine and of the protocol engine
   (``naive``, ``sharded``) counted with ``torch.profiler``, each
   ``run_epoch`` under ``torch.cuda.set_sync_debug_mode("error")``, and
   the syncs per protocol step and per decoded token counted in "warn"
   mode, printed as ``[analyze-card]`` lines. A finding that is neither
   in ``results/analyze_torch/baseline.json`` nor suppressed fails the
   run.
20. Elastic membership over ranks (``elastic_ranks_phase``, last, after
   phase 18 (b)-(d)): ``elastic/planned_churn`` at ``mlp_h1024`` on 8
   ranks sharing the card over gloo (spawned), each segment on the
   reference's mesh for its fleet, (5,1,1) / (4,2,1) / (5,1,1), ranks 5-7
   idle in the G = 5 segments; uninterrupted, with ``ckpt_every=4``, and
   killed after step 12 and resumed (both bit-identical to the
   uninterrupted run on every rank). Per rank: the segment meshes, the
   bytes by tag in each segment (pull + aggregate equal to
   ``collective_volume_bytes`` a step on the rank's columns, 0 on an idle
   rank) and at each boundary (``reform`` equal to
   ``reform_volume_bytes``), the median, Gram and selection launches (at
   least one a step each), peak memory; every rank's results, counters
   and generator equal to rank 0's. Against phase 12 (c)'s one-rank card
   run: the whole params within rel-L2 1e-4 and rel-max 1e-3, the equal
   selections counted; steps/s and the phase's seconds.
21. The 'model' axis for the paper's MLPs over ranks (``mlp_model_phase``,
   last): ``quickstart`` at ``mlp_h1024`` on its ``mixture10_easy`` (P =
   1,093,642), G = 4 (f_w = 1, ALIE on one worker), T = 5, 12 steps of the
   protocol engine on numpy quorum tables and batches, first on one card
   in this process, then on 4 ranks sharing the card over gloo at (rep 2,
   fsdp 1, model 2): w0 column-parallel, w1 and w2 row-parallel, the
   biases whole on every rank (P_m = 547,850). Per rank and step: the
   bytes by tag (pull + aggregate equal to ``collective_volume_bytes`` on
   the rank's blocks, 'model' and 'model_loss' to ``model_volume_bytes``,
   no 'model_leaves'); per rank the median, Gram and selection launches
   (at least one a step each) and peak memory; every rank's whole params
   equal to rank 0's. Against the one-card run: rel-L2 under 1e-4, the
   MDA selections equal at every step whose one-card best subset diameter
   is clear of a tie (the count printed); steps/s and the phase's seconds.
   ``python3 tools/mlp_model_phase.py`` runs it alone.

The profiler windows are read from their raw trace records in one pass
(``trace_events``), not through ``key_averages()`` / ``events()``, whose
parse took ~290 s of the script. Phases print on earlier lines; the line
before the last holds the card's name and power limit, the one before it
the kernels' JSON record (``launches`` over every main-path run,
``mesh_launches`` phase 15's share, ``tp_launches`` phases 16-17's,
``elastic_launches`` phase 20's, ``mlp_model_launches`` phase 21's), and
the
last line is ``{"ok": true,
"device": {...}}``. Exits non-zero, with no result line, when CUDA is
absent or any check fails.
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
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


#: mangled kernel name -> ``_build.PtxasUsage`` (registers, spill, stack
#: frame), from this run's build (``_build.ptxas_usage``)
PTXAS: dict = {}


def ptxas_text(u) -> str:
    return (f"{u.registers} registers, spill {u.spill_stores} B stores / "
            f"{u.spill_loads} B loads, {u.stack} B stack frame")


def ptxas_note(fragment: str) -> str:
    """``ptxas`` registers, spill and stack frame of the kernel whose
    mangled name holds ``fragment``, as this run's build reported them."""
    hits = [v for k, v in PTXAS.items() if fragment in k]
    if not hits:
        return f"; ptxas: no report for {fragment} (library not built here)"
    return "; ptxas " + ptxas_text(hits[0])


def kernel_label(mangled: str) -> str:
    """``_ZN..19meamed_exact_kernelILi5ELi2EE..`` -> ``meamed_exact_kernel<5,
    2>``: the length-prefixed name that ends in ``_kernel``, with its
    integer template arguments."""
    for m in re.finditer(r"(?=(\d+))", mangled):      # every digit run's tail
        end = m.start() + len(m.group(1))
        name = mangled[end:end + int(m.group(1))]
        if name.endswith("_kernel"):
            args = re.match(r"I((?:Li\d+E)+)E", mangled[end + len(name):])
            return name + (f"<{', '.join(re.findall(r'Li(\d+)E', args[1]))}>"
                           if args else "")
    return mangled


def meamed_build_check(build) -> None:
    """Each MeaMed kernel instance's ``ptxas`` registers and stack frame and
    its SASS instruction count (``cuobjdump -sass``, where the toolkit has
    it); fails if an instance has a stack frame (its column left the
    registers)."""
    inst = {k: v for k, v in PTXAS.items() if "meamed" in k}
    if not inst:
        log("[build] cwise_median: no ptxas report (library not built here)")
        return
    sass = build.sass_counts(build.lib_path("cwise_median"))
    for k, u in sorted(inst.items(), key=lambda kv: kernel_label(kv[0])):
        log(f"[build] MeaMed {kernel_label(k)}: {ptxas_text(u)}, "
            + (f"{sass[k]} SASS instructions" if k in sass
               else "SASS not counted (no cuobjdump)"))
    framed = [kernel_label(k) for k, u in inst.items() if u.stack]
    if framed:
        raise AssertionError(f"MeaMed instances with a stack frame: {framed}")


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

def _sdpa_mask(Sq: int, Skv: int, window: int, causal: bool, dev) -> dict:
    """The library call's mask arguments for the same attention."""
    if not causal:
        return {}
    if not window:
        return dict(is_causal=True)
    i = torch.arange(Sq, device=dev)[:, None] + (Skv - Sq)
    j = torch.arange(Skv, device=dev)[None]
    return dict(attn_mask=(j <= i) & (j > i - window))


def flash_row(dev, B, S, H, kvH, hd, window, tag="kernel", *, Skv=None,
              causal: bool = True, main: bool = True,
              scale: float | None = None):
    """The flash forward at q ``[B, S, H, hd]``, k/v ``[B, Skv, kvH, hd]``
    bf16 (Skv = S by default; causal, or not; the softmax ``scale``, by
    default ``1/sqrt(hd)``): error against the plain
    version, two launches bit-equal, and the times of the kernel, the plain
    version and SDPA, cold in L2, beside the bound. ``main`` marks a row of
    the serving or protocol path's own shapes (the kernels line's)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    Skv = S if Skv is None else Skv
    g = torch.Generator(device=dev).manual_seed(S + window + hd)
    q = torch.randn((B, S, H, hd), generator=g, device=dev).bfloat16()
    k = torch.randn((B, Skv, kvH, hd), generator=g, device=dev).bfloat16()
    v = torch.randn((B, Skv, kvH, hd), generator=g, device=dev).bfloat16()
    kw = dict(causal=causal, window=window, scale=scale)
    o, lse = ops.flash_attention(q, k, v, **kw)
    o2, lse2 = ops.flash_attention(q, k, v, **kw)
    po, plse = attention_ref(q, k, v, return_lse=True, **kw)
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
    ms = cold_ms(lambda *t: ops.flash_attention(*t, **kw), (q, k, v), iters)
    plain_ms = cold_ms(lambda *t: attention_ref(*t, **kw), (q, k, v),
                       max(iters // 4, 5))
    lib = _sdpa_mask(S, Skv, window, causal, dev)
    library_ms = cold_ms(lambda *t: F.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in t), enable_gqa=True, scale=scale,
        **lib), (q, k, v), iters)
    # the work these inputs need: visible (q, k) pairs only, at the true hd
    # (the kernel package's count, which the dry run reads too)
    flops, nbytes = ops.fwd_work(B, S, Skv, H, kvH, hd, 2, causal, window)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    shape = f"{S}" + (f"/{Skv}" if Skv != S else "")
    log(f"[{tag}] flash_attention [{B}, {shape}, {H}/{kvH}, {hd}] "
        f"{'causal' if causal else 'non-causal'} "
        f"window={window}{'' if scale is None else f' scale={scale:g}'} "
        f"rows={B * H}: max|o-plain|={err:.3g} "
        f"max|lse-plain|={lse_err:.3g}, two launches bit-equal {same} | "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
        f"{library_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * b_ms / ms:.1f} % of the "
        f"bound" + ptxas_note("tc10fwd_kernel"))
    return dict(S=S, window=window, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                bound_by=b_by, main=main)


def flash_phase(dev):
    # R*H = 96 rows, phi4's heads: serving's prefills (S 128 and 1000,
    # causal and windowed) and the protocol run's shape (S 1024); then
    # granite-h-4k's protocol shape, hd 64 (padded to 128) at its muP
    # softmax scale 1/64
    return [flash_row(dev, N_REPLICAS, S, 24, 8, 128, window)
            for S, window in ((128, 0), (1000, 0), (1000, 256), (1024, 0))
            ] + [flash_row(dev, 4, 4096, 32, 8, 64, 0, scale=1 / 64)]


def median_phase(dev):
    from repro_torch.kernels.cwise_median import ops
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
        n_ops, nbytes = ops.median_work(1, n, D)
        b_ms, b_by = bound(nbytes, n_ops, F32_FLOPS)
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
    return _profile(f"{len(prompts)} x 256-token prefill + {max_new} tokens "
                    f"each on {svc.pool.n_replicas} replicas",
                    lambda: svc.generate(prompts, max_new=max_new))


def trace_events(prof) -> list:
    """The window's raw trace records (``_KinetoEvent``), read as they come:
    no ``FunctionEvent`` is built and no tree, the parse
    ``key_averages()`` and ``events()`` make, which took minutes on the
    long windows."""
    return list(prof.profiler.kineto_results.events())


def _profile(label: str, fn, keep: bool = False):
    """Run ``fn`` under torch.profiler: device busy share of the wall time
    and the kernels that take the most device time, from one pass over the
    raw records (with ``keep``, also the records and the wall in µs)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    t0 = time.perf_counter()
    events = trace_events(prof)
    cuda = torch.autograd.DeviceType.CUDA
    by_name: dict = {}
    # kernels only: a record_function range also shows on the device's
    # timeline, as a span that would count its gaps as busy
    for e in events:
        if e.device_type() == cuda and not e.is_user_annotation():
            ns, n = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (ns + e.duration_ns(), n + 1)
    busy_us = sum(ns for ns, _ in by_name.values()) / 1e3
    log(f"[profile] {label}: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}% of wall); "
        f"the trace's parse {time.perf_counter() - t0:.1f} s "
        f"({len(events)} records)")
    for name, (ns, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0]
                                )[:10]:
        log(f"[profile]   {ns / 1e6:9.2f} ms {n:6d} x  {name[:90]}")
    if keep:
        return busy_us / wall_us, events, wall_us
    return busy_us / wall_us


# ---------------------------------------------------------------------------
# training phases (the ByzSGD loop on mlp_h1024)
# ---------------------------------------------------------------------------

TRAIN_MODEL = "mlp_h1024"
REF_STEPS = 23                                   # 2T + 3 at T = 10


def _row(label, err, ms, plain_ms, library_ms, work, extra="",
         tag="train-kernel"):
    """A kernel row: ``work`` is the kernel package's (operations, bytes)
    count of the call (the one the dry run reads)."""
    ops, nbytes = work
    b_ms, b_by = bound(nbytes, ops, F32_FLOPS)
    lib = "—" if library_ms is None else f"{library_ms:.4f} ms"
    log(f"[{tag}] {label}: max|kernel-plain|={err:.3g} | kernel "
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
    the 5 equivocated servers; the protocol: 4 servers take 3 gradients
    with f = 1)."""
    from repro_torch.kernels.cwise_median import ops as order_ops
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
            order_ops.median_work(B, n, D)))
    # trimmed mean: the gallery's servers [5, 7, D], f = 2; the same sorted
    # rows added in the same order and one IEEE division: exact
    x = stack(5, 7, 57)
    err = exact(order_ops.cwise_trimmed_mean(x, 2),
                order_ops.cwise_trimmed_mean_plain(x, 2))
    rows["cwise_trimmed_mean"].append(_row(
        f"cwise_trimmed_mean [5, 7, {D}] f=2", err,
        cold_ms(lambda t: order_ops.cwise_trimmed_mean(t, 2), (x,), 100),
        cold_ms(lambda t: order_ops.cwise_trimmed_mean_plain(t, 2), (x,), 20),
        None, order_ops.trimmed_mean_work(5, 7, D, 2)))
    # MeaMed: sync_filters' equivocated refresh [5, 5, D], f = 1; exact
    x = stack(5, 5, 55)
    err = exact(order_ops.cwise_meamed(x, 1),
                order_ops.cwise_meamed_plain(x, 1))
    plan = order_ops.meamed_plan(5, D, x.data_ptr())
    rows["cwise_meamed"].append(_row(
        f"cwise_meamed [5, 5, {D}] f=1", err,
        cold_ms(lambda t: order_ops.cwise_meamed(t, 1), (x,), 100),
        cold_ms(lambda t: order_ops.cwise_meamed_plain(t, 1), (x,), 20),
        None, order_ops.meamed_work(5, 5, D, 1),
        f"; {plan.path} kernel, {plan.wires} wires, {4 * plan.vec}-byte "
        f"loads" + ptxas_note(f"meamed_exact_kernelILi5ELi{plan.vec}E")))
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
        gram_ops.gram_work(5, 7, D),
        f", max|d2| err / scale {(d2_err / scale.clamp(min=1e-30)).max().item():.2g}"
        + gram_note(gram_ops, x)))
    # exact MDA selection (SELECT_CASES); quickstart's on this Gram's d2
    for label, B, n, f, on_path in SELECT_CASES:
        d2 = (sqdists_from_gram(got) if label == "quickstart servers"
              else select_distances(dev, B, n))
        rows["subset_diameters"].append(
            select_row(dev, label, d2.contiguous(), f, on_path))
    return rows


# the exact MDA selections timed: label, B, n, f, on the main path.
# quickstart's 5 servers over 7 gradients, f = 2 (C(7, 5) = 21 subsets), the
# protocol's 4 servers over q = 3, f = 1 (3), and one large S off the path
# (C(20, 12) = 125,970)
SELECT_CASES = (("quickstart servers", 5, 7, 2, True),
                ("protocol quorum", 4, 3, 1, True),
                ("large S, off the path", 1, 20, 8, False))
#: label -> device work per selection of (the replaced route, the kernel)
SELECT_OPS: dict[str, tuple[dict, dict]] = {}


def select_distances(dev, B: int, n: int):
    """Seeded ``[B, n, n]`` squared distances of 64-wide points."""
    from repro_torch.kernels.pairwise_sqdist import ops as gram_ops
    from repro_torch.kernels.pairwise_sqdist.ref import sqdists_from_gram
    g = torch.Generator(device=dev).manual_seed(B * 100 + n)
    return sqdists_from_gram(gram_ops.gram_plain(
        torch.randn((B, n, 64), generator=g, device=dev))).contiguous()


def _select_routes(d2, f: int):
    """(the route the kernel replaced, the kernel's) for one selection: the
    diameters kernel, then torch.argmin, the mask table copied to the card,
    the gather, the cast and the division in ``rules``; the dispatch."""
    from repro_torch.agg import dispatch, rules
    return ((lambda: rules.mda_weights_from_d2(
        d2, f, diameters_fn=dispatch.subset_diameters)),
            (lambda: dispatch.mda_weights_from_d2(d2, f)))


def select_launch_phase(dev) -> None:
    """Device kernels, copies and memsets per exact MDA selection, on each
    route, counted with torch.profiler. Run first, before any CUDA graph:
    after graph replays, the profiler was seen to drop kernel records in
    this process. Fails unless the kernel's route is one launch and no
    copy."""
    for label, B, n, f, _ in SELECT_CASES:
        old, new = _select_routes(select_distances(dev, B, n), f)
        SELECT_OPS[label] = device_ops(old), device_ops(new)
        log(f"[select-launches] {label} [{B}, {n}, {n}] f={f}: per "
            f"selection, replaced route {SELECT_OPS[label][0]}, kernel "
            f"{SELECT_OPS[label][1]}")
        if SELECT_OPS[label][1] != {"kernels": 1.0, "copies": 0.0,
                                    "memsets": 0.0}:
            raise AssertionError(f"selection {label}: "
                                 f"{SELECT_OPS[label][1]} per selection, "
                                 f"not one launch")


def device_ops(fn, reps: int = 20) -> dict[str, float]:
    """Device kernels, copies and memsets per call of ``fn``, counted by
    torch.profiler over ``reps`` calls after a warm call. The profiler can
    drop activity records; a window in which some device operation was not
    seen a whole multiple of ``reps`` times is taken again, up to three
    times."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = {e.key: e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}
        if seen and all(c % reps == 0 for c in seen.values()):
            break
    got = {"kernels": 0, "copies": 0, "memsets": 0}
    for key, c in seen.items():
        got["copies" if "Memcpy" in key else "memsets" if "Memset" in key
            else "kernels"] += c
    return {k: v / reps for k, v in got.items()}


def host_us_in_turns(fns: dict, reps: int = 200) -> dict[str, float]:
    """Host wall of one call of each of ``fns`` (ending in a synchronize),
    in µs, timed in turns (a, b, b, a) and averaged."""
    def one(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e6
    for fn in fns.values():
        one(fn)                                          # warm
    names = list(fns)
    walls = {k: [] for k in names}
    for k in names + names[::-1]:
        walls[k].append(one(fns[k]))
    return {k: float(np.mean(v)) for k, v in walls.items()}


def select_row(dev, label: str, d2, f: int, on_path: bool) -> dict:
    """The selection kernel on ``d2`` ``[B, n, n]`` against its plain
    version (diameters and weights exact), timed beside an empty kernel;
    the host wall of one whole selection in turns with the route it
    replaced, and each route's device work per selection
    (:func:`select_launch_phase`)."""
    from repro_torch.kernels.mda_diameter import ops as diam_ops
    B, n = d2.shape[:2]
    S, k = diam_ops.n_subsets(n, f), n - f
    diam, w = diam_ops.mda_select(d2, f)
    want_diam, want_w = diam_ops.mda_select_plain(d2, f)
    torch.cuda.synchronize()
    torch.testing.assert_close(diam, want_diam, rtol=0, atol=0)
    torch.testing.assert_close(w, want_w, rtol=0, atol=0)
    err = max((diam - want_diam).abs().max().item(),
              (w - want_w).abs().max().item())
    old, new = _select_routes(d2, f)
    if not torch.equal(old(), new()):
        raise AssertionError(f"selection {label}: the kernel's weights differ "
                             f"from the rules' route")
    big = S > 10_000
    ms = cold_ms(lambda t: diam_ops.mda_select(t, f), (d2,), 20 if big else 200)
    plain_ms = cold_ms(lambda t: diam_ops.mda_select_plain(t, f), (d2,),
                       5 if big else 50)
    floor_ms = cold_ms(lambda t: torch.cuda._sleep(0), (d2,), 200)
    walls = host_us_in_turns({"replaced route": old, "kernel": new},
                             reps=20 if big else 200)
    ops_old, ops_new = SELECT_OPS[label]
    log(f"[train-kernel] selection {label} [{B}, {n}, {n}] f={f}: device "
        f"work per selection, replaced route {ops_old}, kernel {ops_new}; "
        f"host wall of one selection (in turns) replaced route "
        f"{walls['replaced route']:.1f} µs, kernel {walls['kernel']:.1f} µs; "
        f"an empty kernel {floor_ms:.4f} ms")
    row = _row(f"mda_select [{B}, {n}, {n}] x {S} subsets ({label})", err, ms,
               plain_ms, None, diam_ops.select_work(B, n, S, k),
               f"; empty-kernel floor {floor_ms:.4f} ms"
               + ptxas_note("mda_select_kernel"))
    return dict(row, main=on_path)


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


def _card_and_cpu(dev, e, tables, x, y, tag: str):
    """The stepwise simulator of ``e`` over ``tables`` and the batches
    ``(x, y)`` on the CPU (plain versions) and on the card (kernels), from
    one model: (final params per side, MDA selections per side)."""
    import dataclasses

    from repro_torch.agg import registry
    from repro_torch.core.quorum import TraceDelivery
    cfg = e.to_config()
    steps = x.shape[0]
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
                                       for i in range(steps)])
            params = state.params.cpu()
            wall = time.perf_counter() - t0
        finally:
            registry._REGISTRY["mda"] = mda
        out[key] = params
        log(f"[{tag}] {key}: {steps} steps in {wall:.1f} s")
    return out, sels


def train_reference_phase(dev):
    """quickstart at mlp_h1024 for 2T + 3 steps on shared quorum tables and
    numpy batches: the card's kernels against the CPU's plain versions."""
    from repro_torch.exp import presets
    e = presets.get("quickstart", model=TRAIN_MODEL, steps=REF_STEPS)
    cfg = e.to_config()
    rng = np.random.default_rng(SEED)
    tables = _quorum_tables(rng, cfg, REF_STEPS)
    x, y = _mixture_batches(rng, REF_STEPS, cfg.n_workers, e.batch,
                            e.mixture)
    out, sels = _card_and_cpu(dev, e, tables, x, y, "train-ref")
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
    from repro_torch.kernels.wkv_scan import ops as wkv_ops
    return {"cwise_median": order_ops.cwise_median,
            "cwise_trimmed_mean": order_ops.cwise_trimmed_mean,
            "cwise_meamed": order_ops.cwise_meamed, "gram": gram_ops.gram,
            "subset_diameters": diam_ops.subset_diameters,
            "wkv_scan_fwd": wkv_ops.scan_fwd, "wkv_scan_bwd": wkv_ops.scan_bwd}


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
    results["busy"] = _profile(
        f"quickstart {TRAIN_MODEL}, 20 fused steps",
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
    # label, B, Sq, Skv, H, kvH, hd, window, dtype, causal, softmax scale
    # (None: 1/sqrt(hd))
    ("protocol shape", 4, 1024, 1024, 24, 8, 128, 0, torch.bfloat16, True,
     None),
    ("ragged windowed GQA", 2, 1000, 1000, 24, 8, 128, 256, torch.bfloat16,
     True, None),
    ("padded hd 32", 4, 64, 64, 4, 2, 32, 0, torch.float32, True, None),
    ("granite-h-4k shape, scale 1/64", 4, 4096, 4096, 32, 8, 64, 0,
     torch.bfloat16, True, 1 / 64),
)


def flash_bwd_phase(dev, cases=BWD_CASES, main: bool = True):
    """The dq and dkv kernels against the plain backward, timed; ``main``
    marks rows of the protocol path's own shapes (the kernels line's)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_bwd_from_delta, flash_delta)
    rows = {"flash_bwd_dq": [], "flash_bwd_dkv": []}
    for label, B, Sq, Skv, H, kvH, hd, window, dt, causal, scale in cases:
        g = torch.Generator(device=dev).manual_seed(Sq + hd + window)
        q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dt)
        k = torch.randn((B, Skv, kvH, hd), generator=g, device=dev).to(dt)
        v = torch.randn((B, Skv, kvH, hd), generator=g, device=dev).to(dt)
        do = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dt)
        attn = dict(causal=causal, window=window, scale=scale)
        o, lse = ops.flash_attention(q, k, v, **attn)
        got = ops.flash_attention_bwd(q, k, v, o, lse, do, **attn)
        again = ops.flash_attention_bwd(q, k, v, o, lse, do, **attn)
        delta = flash_delta(o, do).contiguous()
        want = flash_bwd_from_delta(q, k, v, do, lse, delta, **attn)
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
        kw = dict(attn, scale=hd ** -0.5 if scale is None else scale)
        dq_ms = cold_ms(lambda *t: ops.flash_bwd_dq(*t, **kw),
                        (qp, kp, vp, dop, lse, delta), 10)
        dkv_ms = cold_ms(lambda *t: ops.flash_bwd_dkv(*t, **kw),
                         (qp, kp, vp, dop, lse, delta), 10)
        plain_ms = cold_ms(lambda *t: flash_bwd_from_delta(*t, **attn),
                           (q, k, v, do, lse, delta), 3)
        # the library's backward of the same attention (dq, dk, dv at once)
        library_ms = sdpa_bwd_ms(q, k, v, do, dict(
            _sdpa_mask(Sq, Skv, window, causal, dev), scale=scale))
        # the work these inputs need: visible (q, k) pairs, the true hd (the
        # kernel package's counts, which the dry run reads too)
        es = torch.finfo(dt).bits // 8
        for name, ms, count in (("flash_bwd_dq", dq_ms, ops.bwd_dq_work),
                                ("flash_bwd_dkv", dkv_ms, ops.bwd_dkv_work)):
            flops, nbytes = count(B, Sq, Skv, H, kvH, hd, es, causal, window)
            b_ms, b_by = bound(nbytes, flops,
                               BF16_FLOPS if dt == torch.bfloat16
                               else F32_FLOPS)
            rows[name].append(dict(label=label, max_abs_err=max(errs), ms=ms,
                                   plain_ms=plain_ms, library_ms=library_ms,
                                   bound_ms=b_ms, bound_by=b_by, flops=flops,
                                   main=main))
            log(f"[bwd-kernel] {name} {label} [B {B}, S {Sq}/{Skv}, heads "
                f"{H}/{kvH}, hd {hd}, window {window}, {str(dt)[6:]}, "
                f"{'causal' if causal else 'non-causal'}]: "
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


def _tiny_protocol(preset: str = "lm/tfm_tiny",
                   arch: str = "phi4-mini-3.8b", **over) -> dict:
    """``preset``'s protocol with an ALIE worker on ``arch`` reduced (f32
    activations, ``over`` config fields): its bundle, config, schedule,
    2T + 1 steps of numpy quorum tables and token batches, and the initial
    state on the CPU."""
    import dataclasses

    from repro_torch.core import protocol
    from repro_torch.core.attacks import ByzantineSpec
    from repro_torch.exp import presets
    from repro_torch.models.registry import get_bundle
    e = presets.get(preset)
    pcfg = dataclasses.replace(e.to_protocol_config(), byz=ByzantineSpec(
        worker_attack="alie", n_byz_workers=1))
    T, G = pcfg.T, pcfg.n_groups
    steps = 2 * T + 1
    bundle = get_bundle(arch, reduced=True, act_dtype="float32", **over)
    rng = np.random.default_rng(SEED)
    tables = _token_tables(rng, G, pcfg.q_workers, pcfg.q_servers, T, steps)
    toks = rng.integers(0, bundle.cfg.vocab,
                        (steps, G, e.to_dict()["batch"], 65))
    return dict(preset=preset, bundle=bundle, pcfg=pcfg, tables=tables,
                schedule=e.build_schedule(), steps=steps,
                batches={"tokens": torch.from_numpy(toks[..., :-1]),
                         "labels": torch.from_numpy(toks[..., 1:])},
                init=protocol.make_init_fn(bundle, pcfg, "cpu")(SEED))


def _tiny_run(run: dict, d, mesh=None):
    """``_tiny_protocol``'s run on device ``d`` (on ``mesh``'s ranks):
    the whole final params on the CPU, every server's MDA selection per
    step, and the wall seconds."""
    import dataclasses

    from repro_torch.agg import registry
    from repro_torch.core import protocol
    from repro_torch.core.quorum import TraceDelivery
    pcfg = run["pcfg"]
    eng = protocol.ProtocolEngine(
        run["bundle"], pcfg, run["schedule"], with_attack=True,
        delivery=TraceDelivery(*run["tables"], T=pcfg.T, device=d),
        device=d, mesh=mesh)
    init = run["init"]
    state = protocol.shard_state(init._replace(
        params=init.params.clone().to(d),
        gen=torch.Generator(d).manual_seed(1)), mesh,
        protocol.model_split(run["bundle"].cfg, init.tree, mesh))
    mda, picked = registry.get("mda"), []

    def record(d2, f, **kw):
        w = mda.weights_from_d2(d2, f, **kw)
        picked.append((w > 0).cpu())
        return w

    registry._REGISTRY["mda"] = dataclasses.replace(
        mda, weights_from_d2=record)
    try:
        t0 = time.perf_counter()
        state, _ = eng.run(state, {k: v.to(d) for k, v in
                                   run["batches"].items()})
        params = protocol.whole_state(state).params.cpu()
        wall = time.perf_counter() - t0
    finally:
        registry._REGISTRY["mda"] = mda
    return params, picked, wall


def protocol_reference_phase(dev, preset: str = "lm/tfm_tiny",
                             arch: str = "phi4-mini-3.8b", **over):
    """``preset``'s model (``arch`` reduced, f32 activations, ``over``
    config fields) through the ProtocolEngine: card vs CPU."""
    run = _tiny_protocol(preset, arch, **over)
    out, sels = {}, {}
    for key, d in (("cpu", torch.device("cpu")), ("card", dev)):
        out[key], sels[key], wall = _tiny_run(run, d)
        log(f"[protocol-ref] {preset} {key}: {run['steps']} steps in "
            f"{wall:.1f} s")
    return _tiny_compare(run, out, sels, "protocol-ref", "card")


_TINY_CPU: dict = {}


def _tiny_cpu(run: dict):
    """``_tiny_run`` of ``run`` on the CPU, once a script for each preset
    and model (phases 15 (c) and 16 (c) hold their ranks against the same
    run)."""
    key = (run["preset"], run["bundle"].cfg.name)
    if key not in _TINY_CPU:
        _TINY_CPU[key] = _tiny_run(run, torch.device("cpu"))
    return _TINY_CPU[key]


def _tiny_compare(run, out, sels, tag, key):
    """Gate ``out[key]`` against ``out["cpu"]``: every MDA selection equal,
    params within float32 summation-order drift."""
    steps, G = run["steps"], run["pcfg"].n_groups
    if not torch.isfinite(out[key]).all():
        raise AssertionError(f"{tag}: non-finite params on the card")
    same = (len(sels["cpu"]) == len(sels[key]) == steps
            and all(torch.equal(a, b) for a, b in zip(sels["cpu"],
                                                      sels[key])))
    err = (out[key] - out["cpu"]).abs().max().item()
    log(f"[{tag}] {run['preset']} ({run['bundle'].cfg.name} reduced) f32 "
        f"(P = {out['cpu'].shape[1]}, G = "
        f"{G}, ALIE x1), {steps} steps, 2 gathers: {key} (kernels) vs CPU "
        f"(plain versions) max|params diff|={err:.3g} (max|param| "
        f"{out['cpu'].abs().max().item():.3g}); every MDA selection matched "
        f"({steps} steps x {G} servers): {same}")
    if not same:
        raise AssertionError(f"{tag}: an MDA selection differs between the "
                             "card and the CPU")
    # float32 sums in other orders (cuBLAS, the flash kernels' tiles, the
    # Gram kernel's chunks), carried through 11 steps of training
    torch.testing.assert_close(out[key], out["cpu"], rtol=1e-3, atol=1e-4)
    return err


PROTO_STEPS = 11
# sgd with inverse_linear(0.002, 0.005): the JAX launcher's lr0 of 0.02 suits
# its reduced (d_model 128) model; at the full width of 3072 one step of it
# overshoots, and the loss rises instead of falling
PROTO_ARGV = ["--arch", "phi4-mini-3.8b", "--depth", "2", "--groups", "4",
              "--T", "5", "--seq", "1024", "--batch-per-group", "4",
              "--steps", str(PROTO_STEPS), "--lr", "0.002", "--worker-attack",
              "alie", "--n-byz", "1", "--log-every", "1"]


def _zero_counts(counters) -> None:
    for c in counters.values():
        c.launches = 0


def _read_counts(counters) -> dict:
    torch.cuda.synchronize()
    return {k: c.launches for k, c in counters.items()}


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
        gram_ops.gram_work(1, G, P),
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
            order_ops.median_work(batch, n, cols)))
    return rows


@contextlib.contextmanager
def _selections():
    """Every step's MDA quorum weights ``[G, G]`` of the protocol runs
    inside the block (kept on the device until the block ends: no sync)."""
    from repro_torch.core import protocol
    qw, picked = protocol.quorum_weights, []

    def record(*a, **kw):
        w = qw(*a, **kw)
        picked.append(w.clone())
        return w

    protocol.quorum_weights = record
    try:
        yield picked
    finally:
        protocol.quorum_weights = qw
        picked[:] = [w.cpu() for w in picked]


def fingerprint(x: torch.Tensor) -> list[int]:
    """Per-row int64 sums of a float32 stack's bits, each weighted by its
    column mod 65521 plus 1: any change of a bit changes a row's sum (the
    equality of two ``[G, P]`` stacks without a second copy on the card)."""
    bits = x.view(torch.int32)
    out = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    for c0 in range(0, x.shape[1], 2**26):
        c = bits[:, c0:c0 + 2**26].long()
        w = (torch.arange(c0, c0 + c.shape[1], device=x.device) % 65521) + 1
        out += (c * w).sum(dim=1)
    return out.tolist()


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
    with _selections() as picked:
        run = train.main(PROTO_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: c.launches for k, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    # phase 15 (a) runs these steps again through the mesh path
    reference = dict(fingerprint=fingerprint(run.state.params),
                     host=run.state.params.cpu(), selections=picked,
                     peak_gb=peak_gb, P=run.n_params)
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
    # the state after those two steps (t = 13) stays for the checkpoint
    # phase (12 a)
    del run, extra
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
    return got, rows, dict(peak_gb=peak_gb, busy=busy,
                           reference=reference), state



# ---------------------------------------------------------------------------
# the netsim slice: trace-delivered training over realized quorums
# ---------------------------------------------------------------------------

NETSIM_STEPS = 150
NETSIM_RUN = dict(model=TRAIN_MODEL, data="mixture10", model_d=D_MLP_H1024,
                  steps=NETSIM_STEPS, batch=25, eval_n=2048)
# the protocol over a trace that repeats senders: the lm preset at G = 5
CHURN_RUN = dict(delivery="trace", scenario="membership_churn", n_workers=5,
                 f_workers=1, n_servers=5, f_servers=1)


def _repeat_rows(idx) -> int:
    """Quorum rows ``[.., q]`` in which some sender repeats."""
    rows = np.asarray(idx).reshape(-1, np.shape(idx)[-1])
    return int(sum(len(set(r.tolist())) < rows.shape[1] for r in rows))


def netsim_reference_phase(dev):
    """The first REF_STEPS steps of crash_storm's realized trace (9/2
    workers, 5/1 servers, T = 5, the payload of mlp_h1024) through the
    stepwise simulator at mlp_h1024 on numpy batches: the card's kernels
    against the CPU's plain versions, ties between the copies of a
    repeated sender included."""
    from repro_torch.exp import presets
    from repro_torch.netsim import ClusterSim
    e = presets.get("netsim/crash_storm", runner="stepwise",
                    **dict(NETSIM_RUN, steps=presets.get(
                        "netsim/crash_storm").steps))
    t0 = time.perf_counter()
    trace = ClusterSim(e.to_scenario()).run()
    sim_s = time.perf_counter() - t0
    cfg = e.to_config()
    tables = (trace.pull_idx[:REF_STEPS], trace.push_idx[:REF_STEPS],
              trace.gather_idx[:REF_STEPS // cfg.T])
    reps = {k: _repeat_rows(t) for k, t in zip(("pull", "push", "gather"),
                                               tables)}
    log(f"[netsim-ref] crash_storm trace ({cfg.n_workers}/{cfg.f_workers} "
        f"workers, {cfg.n_servers}/{cfg.f_servers} servers, T={cfg.T}, d = "
        f"{D_MLP_H1024}, {trace.scenario.steps} steps simulated in "
        f"{sim_s:.2f} s on the host, {trace.shortfalls} shortfalls): rows "
        f"with a repeated sender in the first {REF_STEPS} steps {reps}")
    if not sum(reps.values()):
        raise AssertionError("the crash_storm window repeats no sender")
    rng = np.random.default_rng(SEED + 2)
    x, y = _mixture_batches(rng, REF_STEPS, cfg.n_workers, e.batch,
                            e.mixture)
    out, sels = _card_and_cpu(dev, e, tables, x, y, "netsim-ref")
    if not torch.isfinite(out["card"]).all():
        raise AssertionError("non-finite params on the card")
    same = (len(sels["cpu"]) == len(sels["card"]) == REF_STEPS
            and all(torch.equal(a, b) for a, b in zip(sels["cpu"],
                                                      sels["card"])))
    err = (out["card"] - out["cpu"]).abs().max().item()
    log(f"[netsim-ref] crash_storm {TRAIN_MODEL} (D = "
        f"{out['cpu'].shape[1]}), {REF_STEPS} steps, "
        f"{REF_STEPS // cfg.T} gathers: card kernels vs CPU plain versions "
        f"max|params diff|={err:.3g} (max|param| "
        f"{out['cpu'].abs().max().item():.3g}); every MDA selection matched "
        f"({REF_STEPS} steps x {cfg.n_servers} servers): {same}")
    if not same:
        raise AssertionError("an MDA selection differs between the card and "
                             "the CPU on the crash_storm trace")
    # as train_reference_phase: float32 sums in other orders over 23 steps
    torch.testing.assert_close(out["card"], out["cpu"], rtol=1e-3, atol=1e-4)
    return err


def netsim_train_phase(dev, quickstart_busy: float):
    """netsim/byzantine_plus_slow at mlp_h1024 for NETSIM_STEPS fused steps
    over its realized trace, then lm/tfm_tiny through the protocol over the
    membership_churn trace; each run's launches counted from 0 around
    it."""
    from repro_torch import exp
    spec = exp.get("netsim/byzantine_plus_slow", **NETSIM_RUN)
    counters = _counters()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters.values():
        c.launches = 0
    res = exp.run(spec, device=dev)
    torch.cuda.synchronize()
    got = {k: c.launches for k, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    ns, acc = res.netsim, res.final["acc"]
    log(f"[netsim] {spec.name} ({spec.variant}, gar {spec.gar}, "
        f"{spec.n_workers}/{spec.f_workers} workers (ALIE x"
        f"{spec.byz.n_byz_workers}, slow), {spec.n_servers}/"
        f"{spec.f_servers} servers, T={spec.T}, {NETSIM_STEPS} steps, "
        f"{TRAIN_MODEL}, batch {spec.batch}): "
        f"{NETSIM_STEPS / res.wall_s:.2f} steps/s ({res.wall_s:.2f} s), "
        f"virtual {ns['virtual_ms']:.1f} ms (mean step "
        f"{ns['mean_step_ms']:.3f} ms, p95 {ns['p95_step_ms']:.3f} ms), "
        f"shortfalls {ns['shortfalls']}, mean pull staleness "
        f"{ns['mean_pull_staleness_ms']:.4f} ms, events {ns['events']}, "
        f"final acc {acc:.4f}, peak device memory {peak_gb:.2f} GB, "
        f"launches {got}")
    log(f"[netsim] {spec.name} acc log " + json.dumps(
        [(m["step"], round(m["acc"], 4)) for m in res.logs]))
    if not np.isfinite(acc) or acc <= 0.2:
        raise AssertionError(f"{spec.name}: final accuracy {acc} is not "
                             f"finite and above 0.2 (twice chance)")
    for k in ("cwise_median", "gram", "subset_diameters"):
        if got[k] <= 0:
            raise AssertionError(f"{k} kernel was not launched by the "
                                 f"{spec.name} run")
    busy = _profile(f"{spec.name} {TRAIN_MODEL}, 20 fused steps",
                    lambda: exp.run(spec.replace(steps=20), device=dev))
    log(f"[netsim] device busy share {100 * busy:.1f}% of wall, against "
        f"quickstart's {100 * quickstart_busy:.1f}% in this run")
    pcounters = _proto_counters()
    for c in pcounters.values():
        c.launches = 0
    res2 = exp.run("lm/tfm_tiny", device=dev, **CHURN_RUN)
    torch.cuda.synchronize()
    got2 = {k: c.launches for k, c in pcounters.items()}
    accs = [m["acc"] for m in res2.logs] + [res2.final["acc"]]
    log(f"[netsim] exp.run('lm/tfm_tiny', {CHURN_RUN}) on the card: "
        f"{res2.summary()}; acc (negative eval loss) log "
        + json.dumps([(m["step"], round(m["acc"], 4)) for m in res2.logs])
        + f"; launches {got2}")
    if not np.all(np.isfinite(accs)):
        raise AssertionError(f"lm/tfm_tiny over membership_churn: "
                             f"non-finite eval losses {accs}")
    if res2.netsim["shortfalls"] <= 0:
        raise AssertionError("the membership_churn trace starved no quorum")
    for k, v in got2.items():
        got[k] = got.get(k, 0) + v
    return got, dict(steps_s=NETSIM_STEPS / res.wall_s, acc=acc,
                     peak_gb=peak_gb, busy=busy)



# ---------------------------------------------------------------------------
# the checkpoint and elastic slice: save and restore at full width, resume,
# serve from a checkpoint, elastic membership
# ---------------------------------------------------------------------------

CKPT_TRAIN = ["--arch", "phi4-mini-3.8b", "--reduced", "--groups", "4",
              "--T", "3", "--seq", "64", "--batch-per-group", "2",
              "--ckpt-every", "5", "--log-every", "1"]
ELASTIC_RUN = dict(model=TRAIN_MODEL)


def _ckpt_root(need: int) -> Path:
    """A fresh directory for a checkpoint of ``need`` bytes: under the
    temporary directory, or, if that disk has too little room, under the
    checkout's git-ignored ``.archive/``. Fails if neither can hold it."""
    import tempfile
    roots = [Path(tempfile.gettempdir()), ROOT / ".archive"]
    free = {}
    for r in roots:
        r.mkdir(parents=True, exist_ok=True)
        free[r] = shutil.disk_usage(r).free
    log("[ckpt] free disk: " + ", ".join(f"{r} {v / 1e9:.2f} GB"
                                         for r, v in free.items())
        + f"; the checkpoint needs {need / 1e9:.2f} GB")
    for r in roots:
        if free[r] > need * 1.05 + 2e9:
            return Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=r))
    raise AssertionError(f"no disk holds the {need / 1e9:.2f} GB checkpoint")


def _quorum_run(pool, bundle, prompts, label: str, tag: str = "ckpt"):
    """8 requests through QuorumService(median, n_slots=4) over ``pool``;
    the flash forward's, the median's and the WKV scan forward's launches
    counted from 0."""
    from repro_torch.kernels.cwise_median import ops as median_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.wkv_scan import ops as wkv_ops
    from repro_torch.serve import QuorumService
    max_len = -(-(max(map(len, prompts)) + MAX_NEW + 1) // 64) * 64
    svc = QuorumService(pool, bundle, n_slots=N_SLOTS, max_len=max_len,
                        n_chunks=4, rule="median")
    flash_ops.flash_attention.launches = 0
    median_ops.cwise_median.launches = 0
    wkv_ops.scan_fwd.launches = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        outs = svc.generate(prompts, max_new=MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {"flash_attention": flash_ops.flash_attention.launches,
           "cwise_median": median_ops.cwise_median.launches,
           "wkv_scan_fwd": wkv_ops.scan_fwd.launches}
    rep = svc.report()
    log(f"[{tag}] {label}: {rep['committed_tokens']} tokens in {wall:.2f} s "
        f"({rep['tok_s']:.2f} tok/s), disagreement "
        f"{rep['disagreement_rate']:.4f}, ejections {rep['ejections']}, "
        f"launches {got}")
    return outs, rep, got


def checkpoint_phase(dev, state):
    """12 (a): phase 10's last protocol state (phi4-mini-3.8b, full width,
    depth 2, G = 4, f32) saved once with the port's checkpointer, restored
    into a ReplicaPool bit-equal, served through quorum reads against the
    live pool, consolidated on the card by restore_consolidated and served
    in bf16; the directory is removed at the end."""
    from repro_torch.checkpoint import checkpointer as ck
    from repro_torch.core.attacks import ByzantineSpec
    from repro_torch.core.protocol import ByzState
    from repro_torch.models.registry import get_bundle
    from repro_torch.serve import ReplicaPool
    bundle = get_bundle("phi4-mini-3.8b", depth=2)
    G, P = state.params.shape
    need = state.params.numel() * state.params.element_size()
    root = _ckpt_root(need)
    launches = {"flash_attention": 0, "cwise_median": 0, "wkv_scan_fwd": 0}
    try:
        t0 = time.perf_counter()
        ck.save(str(root), state.t, state)
        save_s = time.perf_counter() - t0
        d = Path(ck.step_dir(str(root), state.t))
        written = sum(f.stat().st_size for f in d.iterdir())
        params_b = sum(f.stat().st_size for f in d.glob(".params__*"))
        log(f"[ckpt] save: G = {G}, P = {P:,}: {written:,} bytes "
            f"({params_b / 1e9:.2f} GB of .params leaves) in {save_s:.2f} s"
            f", {written / save_s / 1e9:.2f} GB/s")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pool = ReplicaPool.from_checkpoint(str(root), None, f=F_BYZ,
                                           device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        live = state.tree.unflatten(state.params)
        same = all(torch.equal(a, b) for a, b in zip(
            state.tree.leaves(pool.params), state.tree.leaves(live)))
        log(f"[ckpt] ReplicaPool.from_checkpoint onto the card: "
            f"{pool.n_replicas} replicas in {restore_s:.2f} s, "
            f"{need / restore_s / 1e9:.2f} GB/s of params; every leaf "
            f"bit-equal to the live state: {same}")
        if not same:
            raise AssertionError("the restored pool differs from the live "
                                 "state")
        rng = np.random.default_rng(SEED + 12)
        lens = rng.integers(64, 1025, size=N_REQUESTS)
        prompts = [rng.integers(0, bundle.cfg.vocab, n).tolist()
                   for n in lens]
        outs, _, got = _quorum_run(pool, bundle, prompts,
                                   "quorum reads over the restored pool")
        for k, v in got.items():
            launches[k] += v
            if v <= 0 and k != "wkv_scan_fwd":          # phi4: no WKV scan
                raise AssertionError(f"{k} was not launched serving the "
                                     "restored pool")
        base, _, got = _quorum_run(ReplicaPool.from_stacked(live, f=F_BYZ),
                                   bundle, prompts,
                                   "quorum reads over the live pool")
        for k, v in got.items():
            launches[k] += v
        if outs != base:
            bad = [i for i, (a, b) in enumerate(zip(outs, base)) if a != b]
            raise AssertionError(f"requests {bad}: the restored pool's "
                                 "continuations differ from the live one's")
        log(f"[ckpt] token-identical to the live pool ({len(outs)} requests"
            f" x {MAX_NEW} tokens, prompt lengths {lens.tolist()}); sample "
            f"{outs[0][:8]}")
        del live, base
        bad_pool = pool.corrupt(ByzantineSpec(server_attack="reversed",
                                              n_byz_servers=1))
        del pool
        _, rep, got = _quorum_run(bad_pool, bundle, prompts,
                                  "replica 3 corrupted (reversed), "
                                  "reported, not gated")
        for k, v in got.items():
            launches[k] += v
        del bad_pool
        gc.collect()
        torch.cuda.empty_cache()
        from repro_torch.kernels.cwise_median import ops as median_ops
        median_ops.cwise_median.launches = 0
        t0 = time.perf_counter()
        cons, _ = ck.restore_consolidated(str(root), state.t,
                                          ByzState(None, 0, None), dev)
        torch.cuda.synchronize()
        cons_s = time.perf_counter() - t0
        launches["cwise_median"] += median_ops.cwise_median.launches
        log(f"[ckpt] restore_consolidated on the card ([{G}, P] median, "
            f"{median_ops.cwise_median.launches} median launches): "
            f"{cons_s:.2f} s")
        if median_ops.cwise_median.launches <= 0:
            raise AssertionError("restore_consolidated launched no median")
        params = cons.tree.unflatten(cons.params.to(torch.bfloat16))
        del cons
        caches = bundle.init_caches(2, max_len=64, n_chunks=1, device=dev)
        with torch.inference_mode():
            toks = torch.as_tensor([p[:32] for p in prompts[:2]], device=dev)
            logits, caches = bundle.prefill(
                params, {"tokens": toks, "labels": toks}, caches)
            finite = bool(torch.isfinite(logits).all())
            out = [torch.argmax(logits, -1)]
            for _ in range(8):
                logits, caches = bundle.decode(params, caches,
                                               {"token": out[-1][:, None]})
                finite &= bool(torch.isfinite(logits).all())
                out.append(torch.argmax(logits, -1))
        log(f"[ckpt] consolidated bf16 model: prefill 2 x 32, 8 decode "
            f"steps, logits finite {finite}, tokens "
            f"{torch.stack(out, 1)[0].tolist()}")
        if not finite:
            raise AssertionError("the consolidated model's logits are not "
                                 "finite")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches, dict(save_s=save_s, restore_s=restore_s, bytes=written,
                          cons_s=cons_s)


def resume_phase(dev):
    """12 (b): ``launch.train --reduced`` on the card 12 steps in one go
    against 7 steps, killed, and resumed to 12 (bit-equal, t = 12), then
    ``launch.serve --ckpt-dir --quorum`` on that checkpoint; launches counted
    from 0 around the runs."""
    import tempfile
    from repro_torch.launch import serve, train
    counters = _proto_counters()
    for c in counters.values():
        c.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as tmp:
        a, b = f"{tmp}/a", f"{tmp}/b"
        whole = train.main(CKPT_TRAIN + ["--steps", "12", "--ckpt-dir", a])
        train.main(CKPT_TRAIN + ["--steps", "7", "--ckpt-dir", b])
        resumed = train.main(CKPT_TRAIN + ["--steps", "12", "--ckpt-dir",
                                           b])
        torch.cuda.synchronize()
        same = torch.equal(whole.state.params, resumed.state.params)
        log(f"[resume] launch.train --reduced, 12 steps against 7 + resumed "
            f"5 (steps {[i for i, _ in resumed.losses]}): final params "
            f"bit-equal {same}, t {resumed.state.t}; saves "
            f"{sorted(os.listdir(b))}")
        if not same or resumed.state.t != 12 or len(resumed.step_s) != 5:
            raise AssertionError("the resumed launch.train run is not the "
                                 "uninterrupted one")
        rep = serve.main(["--reduced", "--batch", "4", "--prefill", "32",
                          "--decode", "8", "--ckpt-dir", b, "--quorum"])
        torch.cuda.synchronize()
    got = {k: c.launches for k, c in counters.items()}
    log(f"[resume] launch.serve --ckpt-dir --quorum: "
        f"{rep['committed_tokens']} tokens from {rep['n_replicas']} "
        f"replicas; launches over the phase {got}")
    if rep["committed_tokens"] != 32:
        raise AssertionError(f"launch.serve --quorum committed "
                             f"{rep['committed_tokens']} tokens")
    for k in ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv", "gram",
              "subset_diameters", "cwise_median"):
        if got[k] <= 0:
            raise AssertionError(f"{k} was not launched by the resume runs")
    return got


def elastic_phase(dev):
    """12 (c): ``elastic/static`` against ``runner="protocol"``,
    ``elastic/planned_churn`` at ``mlp_h1024`` uninterrupted and killed at
    step 12 and resumed, ``elastic/netsim_churn``; launches counted from 0
    around each run."""
    import tempfile
    from repro_torch import exp
    from repro_torch.core import membership
    from repro_torch.kernels.cwise_median import ops as median_ops
    counters = _counters()
    total = {k: 0 for k in counters}

    def run(name, **kw):
        for c in counters.values():
            c.launches = 0
        res = exp.run(name, device=dev, **kw)
        torch.cuda.synchronize()
        for k, c in counters.items():
            total[k] += c.launches
        return res, {k: c.launches for k, c in counters.items()}

    static, _ = run("elastic/static", **ELASTIC_RUN)
    proto, _ = run("elastic/static", runner="protocol", **ELASTIC_RUN)
    same = torch.equal(static.state.params, proto.state.params)
    log(f"[elastic] elastic/static at {TRAIN_MODEL} bit-identical to "
        f"runner='protocol': {same} (final acc {static.final['acc']:.4f})")
    if not same or static.logs != proto.logs:
        raise AssertionError("elastic/static differs from runner='protocol'")

    seeding = []
    reform = membership.reform_params

    def counted(*a, **k):
        before = median_ops.cwise_median.launches
        out = reform(*a, **k)
        seeding.append(median_ops.cwise_median.launches - before)
        return out

    membership.reform_params = counted
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        with _selections() as picked:
            churn, got = run("elastic/planned_churn", **ELASTIC_RUN)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        steps = churn.experiment.steps
        acc = churn.final["acc"]
        log(f"[elastic] elastic/planned_churn at {TRAIN_MODEL} (G 5 -> 4 at "
            f"step 8 -> 5 at 16, {steps} steps): {steps / churn.wall_s:.2f} "
            f"steps/s ({churn.wall_s:.3f} s), final acc {acc:.4f}, peak "
            f"device memory {peak_gb:.3f} GB, median launches of each "
            f"re-forming (shrink, join) {seeding}, launches {got}")
        if not np.isfinite(acc) or acc <= 0.2:
            raise AssertionError(f"elastic/planned_churn: final accuracy "
                                 f"{acc} is not finite and above 0.2")
        churn_seeding = list(seeding)
        if len(churn_seeding) != 2 or churn_seeding[1] <= 0:
            raise AssertionError(f"the joiner's seeding launched no median: "
                                 f"{churn_seeding}")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_elastic_") as d:
            run("elastic/planned_churn", ckpt_dir=d, ckpt_every=4,
                **ELASTIC_RUN)
            for name in sorted(os.listdir(d)):
                if int(name.split("_")[-1]) > 12:
                    shutil.rmtree(os.path.join(d, name))
            resumed, _ = run("elastic/planned_churn", ckpt_dir=d,
                             ckpt_every=4, **ELASTIC_RUN)
    finally:
        membership.reform_params = reform
    same = torch.equal(churn.state.params, resumed.state.params)
    log(f"[elastic] killed at step 12 and resumed (at "
        f"{resumed.provenance['membership']['resumed_at']}, G' = 4): params "
        f"bit-identical {same}, final acc {resumed.final['acc']:.4f}")
    if not same or resumed.final != churn.final:
        raise AssertionError("the resumed elastic run differs")
    ns, got = run("elastic/netsim_churn", **ELASTIC_RUN)
    finite = bool(torch.isfinite(ns.state.params).all()) and np.isfinite(
        ns.final["acc"])
    epochs = [(e["start"], len(e["active"]))
              for e in ns.provenance["membership"]["epochs"]]
    log(f"[elastic] elastic/netsim_churn: epochs (start, G) {epochs}, "
        f"final acc {ns.final['acc']:.4f}, finite {finite}, launches {got}")
    if not finite:
        raise AssertionError("elastic/netsim_churn is not finite")
    # phase 20 holds its runs over ranks against this one
    return total, dict(steps_s=steps / churn.wall_s, acc=acc,
                       peak_gb=peak_gb, seeding=churn_seeding,
                       params=churn.state.params.cpu(), selections=picked)


# ---------------------------------------------------------------------------
# phase 13: the zoo — the MoE and RWKV6 families at full width
# ---------------------------------------------------------------------------

MOE_ARCH, RWKV_ARCH = "qwen3-moe-235b-a22b", "rwkv6-3b"
# (arch, depth, tag, new tokens of the profiler window): qwen3-moe at depth
# 2 (one bf16 copy 11.05 GB; four replicas, one corrupted, 55 GB);
# rwkv6-3b at depth 8 of 32 (its full depth until phase 18 took its share
# of the script's time limit: ~90 s of host-paced B = 1 decoding), whose
# window decodes 2 tokens: each of its decode steps is ~6k launches at
# this depth, and the profiler's parse of a window grows with the launches
ZOO_SERVE = ((MOE_ARCH, 2, "moe-serve", 8),
             (RWKV_ARCH, 8, "rwkv-serve", 2))
# phase 10's run with the RWKV6 family
ZOO_TRAIN_ARGV = ["--arch", RWKV_ARCH] + PROTO_ARGV[2:]
# the WKV scan's chunk recurrence at rwkv6-4k's training shape (N = 256
# chunks of 16 over S = 4096, B 4, rwkv6-3b's 40 heads of K = V = 64), and
# at the tests' V = 8
WKV_SHAPES = ((256, 4, 40, 64, 64), (37, 2, 3, 8, 8))


def _event_ms(fn, iters: int = 3) -> float:
    """Mean time of one ``fn()`` from the host, CUDA events around
    ``iters`` calls after one unmeasured call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def wkv_scan_phase(dev) -> dict:
    """13 (a): the WKV scan's chunk-recurrence kernels, forward and backward,
    against the plain loops (``scan_fwd_plain``, ``scan_bwd_plain``) at
    :data:`WKV_SHAPES`, from decays in (0, 1] (so the backward's
    ``d_decay`` and carried gradient reach every chunk): each output within
    N roundings of the chain's largest value (N + V for ``d_decay``, V
    products summed in another order), as the card tests hold them; two
    launches bit-equal. At the training shape each kernel is timed cold in
    L2 beside its bound by bytes and the plain loop's device time, with the
    loop with autograd it replaced (``ref.state_scan_ref``, launched from
    the host) as a yardstick."""
    from repro_torch.kernels.wkv_scan import ops as wkv_ops
    from repro_torch.kernels.wkv_scan.ref import state_scan_ref
    eps = 2.0 ** -23                 # float32's spacing at 1
    rows = {"wkv_scan_fwd": [], "wkv_scan_bwd": []}
    for N, B, H, K, V in WKV_SHAPES:
        g = torch.Generator(device=dev).manual_seed(SEED + N)
        decay = 1.0 - torch.rand((N, B, H, K), generator=g, device=dev)
        add, d_ent = (torch.randn((N, B, H, K, V), generator=g, device=dev)
                      for _ in range(2))
        s0, d_fin = (torch.randn((B, H, K, V), generator=g, device=dev)
                     for _ in range(2))
        runs = []
        for _ in range(2):
            ent, fin = wkv_ops.scan_fwd(decay, add, s0)
            runs.append((ent, fin, *wkv_ops.scan_bwd(decay, ent, d_ent,
                                                     d_fin)))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        ent, fin, d_decay, d_add, d_s0 = runs[0]
        del runs
        p_ent, p_fin = wkv_ops.scan_fwd_plain(decay, add, s0)
        p_dd, p_da, p_ds0 = wkv_ops.scan_bwd_plain(decay, ent, d_ent, d_fin,
                                                   True)
        s_max = max(p_ent.abs().max().item(), p_fin.abs().max().item())
        g_max = max(p_da.abs().max().item(), p_ds0.abs().max().item())
        checks = {"entering": (ent, p_ent, N * eps * s_max),
                  "final": (fin, p_fin, N * eps * s_max),
                  "d_add": (d_add, p_da, N * eps * g_max),
                  "d_s0": (d_s0, p_ds0, N * eps * g_max),
                  "d_decay": (d_decay, p_dd, (N + V) * eps * V * g_max
                              * ent.abs().max().item())}
        errs = {k: (a - b).abs().max().item() for k, (a, b, _) in
                checks.items()}
        log(f"[zoo-kernel] wkv_scan [{N}, {B}, {H}, {K}, {V}], decays in "
            f"({decay.min().item():.3g}, {decay.max().item():.3g}]: "
            + ", ".join(f"{k} max|kernel-plain|={errs[k]:.3g} (tol "
                        f"{tol:.3g})" for k, (_, _, tol) in checks.items())
            + f"; two launches bit-equal {same}")
        bad = [k for k, (_, _, tol) in checks.items() if not errs[k] <= tol]
        if bad or not same:
            raise AssertionError(f"wkv_scan at [{N}, {B}, {H}, {K}, {V}]: "
                                 f"{bad} off, bit-equal {same}")
        del p_ent, p_fin, p_dd, p_da, p_ds0, checks
        if (N, B, H, K, V) != WKV_SHAPES[0]:
            continue

        def loop():
            leaves = [t.detach().requires_grad_() for t in (decay, add)]
            e, f = state_scan_ref(*leaves, s0)
            torch.autograd.grad((e, f), leaves, (d_ent, d_fin))
        loop_ms = _event_ms(loop)
        shape = f"[{N}, {B}, {H}, {K}, {V}]"
        rows["wkv_scan_fwd"].append(_row(
            f"wkv_scan forward {shape}",
            max(errs["entering"], errs["final"]),
            cold_ms(wkv_ops.scan_fwd, (decay, add, s0), 20),
            cold_ms(wkv_ops.scan_fwd_plain, (decay, add, s0), 3), None,
            wkv_ops.scan_fwd_work(N, B, H, K, V),
            ptxas_note("state_scan_fwd_kernel"), tag="zoo-kernel"))
        rows["wkv_scan_bwd"].append(_row(
            f"wkv_scan backward {shape} (no d_s0)",
            max(errs["d_add"], errs["d_decay"]),
            cold_ms(lambda *t: wkv_ops.scan_bwd(*t, d_s0=False),
                    (decay, ent, d_ent, d_fin), 20),
            cold_ms(lambda *t: wkv_ops.scan_bwd_plain(*t, False),
                    (decay, ent, d_ent, d_fin), 3), None,
            wkv_ops.scan_bwd_work(N, B, H, K, V, False),
            ptxas_note("state_scan_bwd_kernel")
            + f"; the loop with autograd it replaced {loop_ms:.2f} ms a "
            f"forward and backward", tag="zoo-kernel"))
    return rows


def _single_run(bundle, params, prompt, max_len: int, dev):
    """One request alone: a B = 1 prefill and greedy decode to MAX_NEW."""
    c = bundle.init_caches(1, max_len=max_len, n_chunks=4, device=dev)
    lg, c = bundle.prefill(params, {"tokens": torch.tensor(
        [prompt], device=dev)}, c)
    out = [int(lg.argmax(-1))]
    for _ in range(MAX_NEW - 1):
        lg, c = bundle.decode(params, c, {"token": torch.tensor(
            [out[-1:]], device=dev)})
        out.append(int(lg.argmax(-1)))
    return out


def zoo_serve_phase(dev, arch: str, depth, tag: str, window_new: int,
                    window_prompts: int = N_SLOTS):
    """13 (b) / (d), 14 (c): phase 4's quorum run on a zoo arch at full
    width, random bf16 weights: token-identical to an honest single
    replica, every request equal to its own B = 1 run (the MoE's routing
    per slot, the RWKV6 and Mamba2 state reset per request), the kernels of
    the path launched; then a profiler window of ``window_prompts``
    256-token prompts and ``window_new`` tokens each."""
    from repro_torch.core.attacks import ByzantineSpec
    from repro_torch.models.registry import get_bundle, get_config
    from repro_torch.serve import QuorumService, ReplicaPool
    from repro_torch.serve.replica import leaves
    bundle = get_bundle(arch, depth=depth)
    cfg, full = bundle.cfg, get_config(arch).n_layers
    t0 = time.perf_counter()
    params = bundle.init(torch.Generator(device=dev).manual_seed(SEED),
                         dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    cut = (f"depth {cfg.n_layers} of {full} (four bf16 replicas of the full "
           f"depth: {4 * 2 * n / cfg.n_layers * full / 1e9:.0f} GB)"
           if cfg.n_layers < full else f"full depth {full}")
    log(f"[{tag}] {cfg.name} ({cfg.family}) at full width (d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}"
        + (f", {cfg.n_experts} experts top-{cfg.top_k}, d_ff {cfg.d_ff}, "
           f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}"
           if cfg.family == "moe" else
           f", Mamba2 state {cfg.ssm_state}, "
           f"{cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim} SSM heads "
           f"of {cfg.ssm_head_dim}, the shared block after every "
           f"{cfg.shared_attn_every} ({cfg.shared_attn_heads} heads of "
           f"{cfg.d_model // cfg.shared_attn_heads}, d_ff "
           f"{cfg.shared_attn_d_ff})" if cfg.family == "hybrid" else
           f", d_ff {cfg.d_ff}, "
           f"{cfg.d_model // cfg.ssm_head_dim} heads of {cfg.ssm_head_dim}")
        + f"), {cut}: {n / 1e9:.3f} B params, {2 * n / 1e9:.2f} GB a bf16 "
        f"copy, init {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 1025, size=N_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    max_len = -(-(int(lens.max()) + MAX_NEW + 1) // 64) * 64
    pool = ReplicaPool.from_params(params, N_REPLICAS, f=F_BYZ).corrupt(
        ByzantineSpec(server_attack="reversed", n_byz_servers=1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    outs, rep, got = _quorum_run(
        pool, bundle, prompts, f"{N_REPLICAS} replicas (f={F_BYZ}, replica "
        f"{N_REPLICAS - 1} reversed), prompts {lens.tolist()}", tag)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    base, base_rep, _ = _quorum_run(ReplicaPool.from_params(params, 1, f=0),
                                    bundle, prompts, "honest single replica",
                                    tag)
    with torch.inference_mode():
        t0 = time.perf_counter()
        single = [_single_run(bundle, params, p, max_len, dev)
                  for p in prompts]
        torch.cuda.synchronize()
    log(f"[{tag}] quorum run {rep['tok_s']:.2f} tok/s against "
        f"{base_rep['tok_s']:.2f} for one replica (R = 1 ratio "
        f"{rep['tok_s'] / base_rep['tok_s']:.3f}); peak device memory "
        f"{peak_gb:.1f} GB; ejections {rep['ejections']}; the {N_REQUESTS} "
        f"B = 1 runs {time.perf_counter() - t0:.1f} s")
    if outs != base:
        bad = [i for i, (a, b) in enumerate(zip(outs, base)) if a != b]
        raise AssertionError(f"{cfg.name}: requests {bad} differ from the "
                             f"honest single replica")
    if outs != single:
        bad = [i for i, (a, b) in enumerate(zip(outs, single)) if a != b]
        raise AssertionError(f"{cfg.name}: requests {bad} differ from their "
                             f"own B = 1 runs")
    if any(len(o) != MAX_NEW for o in outs):
        raise AssertionError("a request did not reach max_new tokens")
    need = ("cwise_median", "wkv_scan_fwd") if arch == RWKV_ARCH \
        else ("flash_attention", "cwise_median")    # RWKV6 has no attention
    for k in need:
        if got[k] <= 0:
            raise AssertionError(f"{k} was not launched by the {tag} run")
    log(f"[{tag}] token-identical to the honest single replica and every "
        f"request to its own B = 1 run ({N_REQUESTS} x {MAX_NEW} tokens, "
        f"{rep['refills']} refills); sample {outs[0][:8]}; launches {got}")
    with torch.inference_mode():
        profile_window(QuorumService(pool, bundle, n_slots=N_SLOTS,
                                     max_len=320, n_chunks=4),
                       [rng.integers(0, cfg.vocab, 256).tolist()
                        for _ in range(window_prompts)], max_new=window_new)
    return got, dict(tok_s=rep["tok_s"], base_tok_s=base_rep["tok_s"],
                     peak_gb=peak_gb)


def scan_share(events, name: str = "rwkv6.wkv") -> dict:
    """What the ``name`` spans (the program's span of a scan, opened in
    its forward and in its remat recompute) and the backward nodes of the
    ops they ran (matched by autograd sequence number) cost: their
    kernels' device time (the spans' own records on the device's timeline
    left out), the host time the union of their intervals covers, and
    their kernel launches. From the raw records (:func:`trace_events`):
    an op is inside a span when it ran on the span's thread within its
    interval; a kernel and its launch belong to the op whose correlation
    id they link to."""
    import bisect
    cpu = torch.autograd.DeviceType.CPU
    ops: dict = {}                      # thread -> [(start, end, id, seq)]
    kernel_ns: dict = {}                # linked id -> device ns
    launches: dict = {}                 # linked id -> kernel launches
    ranges, roots = [], []
    for e in events:
        link = e.linked_correlation_id()
        if e.device_type() != cpu:
            if not e.is_user_annotation() and e.name() != name:
                kernel_ns[link] = kernel_ns.get(link, 0) + e.duration_ns()
            continue
        if link > 0:                    # a runtime call made for an op
            if "LaunchKernel" in e.name():
                launches[link] = launches.get(link, 0) + 1
            continue
        rec = (e.start_ns(), e.end_ns(), e.correlation_id(), e.sequence_nr())
        ops.setdefault(e.start_thread_id(), []).append(rec)
        if e.name() == name:
            ranges.append((e.start_thread_id(), rec))
        elif e.name().startswith("autograd::engine::evaluate"):
            roots.append((e.start_thread_id(), rec))
    for v in ops.values():
        v.sort()
    starts = {t: [r[0] for r in v] for t, v in ops.items()}

    def inside(thread, rec):
        v = ops[thread]
        lo = bisect.bisect_left(starts[thread], rec[0])
        hi = bisect.bisect_right(starts[thread], rec[1])
        return [r for r in v[lo:hi] if r[1] <= rec[1]]

    fwd = {r[2]: r for t, rec in ranges for r in inside(t, rec)}
    seqs = {r[3] for r in fwd.values() if r[3] >= 0}
    bwd_roots = [(t, rec) for t, rec in roots if rec[3] in seqs]
    bwd = {r[2]: r for t, rec in bwd_roots for r in inside(t, rec)
           if r[2] not in fwd}

    def device_us(part):
        return sum(kernel_ns.get(i, 0) for i in part) / 1e3

    host_ns, end = 0, float("-inf")
    for a, b in sorted(rec[:2] for _, rec in ranges + bwd_roots):
        host_ns += max(0, b - max(a, end))
        end = max(end, b)
    return dict(calls=len(ranges), fwd_device_us=device_us(fwd),
                bwd_device_us=device_us(bwd), host_us=host_ns / 1e3,
                launches=sum(launches.get(i, 0) for i in (*fwd, *bwd)))


def zoo_train_phase(dev):
    """13 (c): phase 10's protocol run with rwkv6-3b at full width, depth
    2, through ``launch/train.py``; launches counted from 0 around the run;
    a two-step profiler window with the WKV scan's share."""
    from repro_torch.data.pipeline import token_stream
    from repro_torch.launch import train
    counters = _counters()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    run = train.main(ZOO_TRAIN_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: c.launches for k, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    losses = [loss for _, loss in run.losses]
    warm = run.step_s[1:]
    log(f"[zoo-train] rwkv6-3b full width (d_model 2560, 40 heads of "
        f"64, d_ff 8960, vocab 65536), depth 2 of 32 (cut as phase 10: "
        f"~14 bytes a param a group), P = {run.n_params:,}, G = 4, f_w = "
        f"1 (ALIE x1), T = 5, {PROTO_STEPS} steps of 4 x 1024 tokens per "
        f"group: {PROTO_STEPS / sum(run.step_s):.3f} steps/s over all "
        f"steps, {len(warm) / sum(warm):.3f} after the first (first "
        f"{run.step_s[0]:.2f} s, then {np.mean(warm):.3f} s each), "
        f"train.main wall {wall:.1f} s, peak device memory "
        f"{peak_gb:.1f} GB")
    log("[zoo-train] loss per step " + json.dumps(
        [(i, round(x, 4)) for i, x in run.losses]))
    log("[zoo-train] launches " + json.dumps(got) + " | per step "
        + json.dumps({k: round(v / PROTO_STEPS, 2)
                      for k, v in got.items()}))
    if not np.all(np.isfinite(losses)) or len(losses) != PROTO_STEPS:
        raise AssertionError(f"rwkv6 losses not finite: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"rwkv6 loss did not fall: {losses}")
    if peak_gb >= 80:
        raise AssertionError(f"peak device memory {peak_gb:.1f} GB")
    for k in ("gram", "subset_diameters", "cwise_median", "wkv_scan_fwd",
              "wkv_scan_bwd"):
        if got[k] < PROTO_STEPS:
            raise AssertionError(f"{k} was launched {got[k]} times in "
                                 f"{PROTO_STEPS} rwkv6 protocol steps")
    extra = list(token_stream(SEED + 1, run.bundle.cfg.vocab, 4, 4,
                              1024, 2, device=dev))
    state = run.state

    def two_steps():
        nonlocal state
        for b in extra:
            state = run.step(state, b)

    busy, events, wall_us = _profile(
        "protocol rwkv6-3b depth 2, 2 steps", two_steps, keep=True)
    sh = scan_share(events)
    dev_ms = (sh["fwd_device_us"] + sh["bwd_device_us"]) / 1e3
    log(f"[zoo-train] the WKV scan in that window: {sh['calls']} calls "
        f"(forward and remat recompute), device {dev_ms:.1f} ms "
        f"(forward {sh['fwd_device_us'] / 1e3:.1f}, backward "
        f"{sh['bwd_device_us'] / 1e3:.1f}) = "
        f"{100 * dev_ms * 1e3 / wall_us:.1f} % of the wall, host "
        f"{sh['host_us'] / 1e3:.1f} ms = "
        f"{100 * sh['host_us'] / wall_us:.1f} % of the wall; "
        f"{sh['launches'] / 2:.0f} launches a step")
    del run, extra, state, events
    gc.collect()
    torch.cuda.empty_cache()
    return got, dict(peak_gb=peak_gb, busy=busy, scan=sh)


def zoo_reference_phase(dev):
    """13 (e): ``lm/moe_tiny`` and ``lm/rwkv_tiny`` in float32 (activations
    and replicas) card against CPU as phase 9; then both presets as
    registered (the MoE's bf16 replicas) on the card, their launches
    counted from 0 around each run."""
    from repro_torch import exp
    counters = _proto_counters()
    total = {k: 0 for k in counters}
    for preset, arch in (("lm/moe_tiny", MOE_ARCH),
                         ("lm/rwkv_tiny", RWKV_ARCH)):
        protocol_reference_phase(dev, preset, arch, param_dtype="float32")
        for c in counters.values():
            c.launches = 0
        res = exp.run(preset, device=dev)
        torch.cuda.synchronize()
        for k, c in counters.items():
            total[k] += c.launches
        log(f"[protocol] exp.run({preset!r}) on the card: {res.summary()}; "
            f"acc (negative eval loss) log "
            + json.dumps([(m["step"], round(m["acc"], 4))
                          for m in res.logs]))
        if not np.isfinite(res.final["acc"]):
            raise AssertionError(f"{preset}: non-finite eval loss")
    return total


# ---------------------------------------------------------------------------
# phase 14: the rest of the zoo — qwen2-vl-7b, zamba2-1.2b, whisper-small
# ---------------------------------------------------------------------------

VLM_ARCH, HYBRID_ARCH, AUDIO_ARCH = ("qwen2-vl-7b", "zamba2-1.2b",
                                     "whisper-small")
# (a): the flash forward at the new families' shapes, bf16: whisper's
# encoder and its cross-attention (non-causal), zamba2's shared block
# (MHA, hd 64), qwen2-vl's GQA with 7 query heads a kv head
ZOO2_FLASH = (
    # B, Sq, H, kvH, hd, Skv, causal
    (4, 1500, 12, 12, 64, 1500, False),
    (4, 1024, 12, 12, 64, 1500, False),
    (4, 1024, 32, 32, 64, 1024, True),
    (4, 1024, 28, 4, 128, 1024, True),
)
ZOO2_BWD = (
    ("whisper encoder", 4, 1500, 1500, 12, 12, 64, 0, torch.bfloat16, False,
     None),
    ("qwen2-vl GQA-7", 4, 1024, 1024, 28, 4, 128, 0, torch.bfloat16, True,
     None),
)
# (b): launch/serve.py's default path, full width and depth
VLM_SERVE_ARGV = ["--arch", VLM_ARCH, "--batch", "4", "--prefill", "1024",
                  "--decode", "32"]
# (c): phase 13 (b)'s quorum run at depth 12 of 38, two shared-attention
# sites (its full depth until phase 18 took its share of the script's time
# limit); the profiler window prefills 2 slots and decodes 2 tokens each
# (the trace's parse grows with the launches)
HYBRID_SERVE = (HYBRID_ARCH, 12, "hybrid-serve", 2, 2)
# (d): phase 10's run at depth 12 (two shared-attention sites)
HYBRID_TRAIN_ARGV = ["--arch", HYBRID_ARCH, "--depth", "12"] + PROTO_ARGV[4:]
AUDIO_STEPS, AUDIO_LR = 4, 0.005


def zoo2_kernel_phase(dev):
    """14 (a): the flash forward, dq and dkv at the new families' shapes,
    each against its plain version and timed as in 2 and 8."""
    fwd = [flash_row(dev, B, S, H, kvH, hd, 0, tag="zoo2-kernel", Skv=Skv,
                     causal=causal, main=False)
           for B, S, H, kvH, hd, Skv, causal in ZOO2_FLASH]
    return fwd, flash_bwd_phase(dev, ZOO2_BWD, main=False)


def _finite_logits(mod, names=("prefill", "decode_step")):
    """Wrap ``mod``'s prefill and decode so every logits they return is
    checked; returns (the record, a function that restores them)."""
    seen = {"calls": 0, "finite": True}
    saved = {n: getattr(mod, n) for n in names}

    def wrap(fn):
        def checked(*a, **k):
            logits, caches = fn(*a, **k)
            seen["calls"] += 1
            seen["finite"] &= bool(torch.isfinite(logits).all())
            return logits, caches
        return checked

    for n, fn in saved.items():
        setattr(mod, n, wrap(fn))
    return seen, lambda: [setattr(mod, n, fn) for n, fn in saved.items()]


def vlm_serve_phase(dev):
    """14 (b): qwen2-vl-7b at full width and depth through
    ``launch/serve.py``'s default path: a 4 x 1024 prefill of merged bf16
    embeddings at ``[3, B, S]`` M-RoPE ids, then 32 decode steps; finite
    logits, the flash forward launched, peak memory; then a profiler
    window of the same prefill and 8 decode steps on the bundle."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_bundle
    from repro_torch.serve.replica import leaves
    seen, restore = _finite_logits(transformer)
    stats = {}
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        flash_ops.flash_attention.launches = 0
        t0 = time.perf_counter()
        toks = serve.main(VLM_SERVE_ARGV, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    launches = {"flash_attention": flash_ops.flash_attention.launches}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    cfg = get_bundle(VLM_ARCH).cfg
    log(f"[vlm-serve] {cfg.name} full width and depth ({cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
        f"heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, M-RoPE "
        f"sections 32/16/16): 4 x 1024 prefill {stats['prefill_s']:.3f} s, "
        f"32 decode steps {stats['decode_s']:.3f} s = {stats['tok_s']:.2f} "
        f"tok/s, launcher wall {wall:.1f} s (init included), peak device "
        f"memory {peak_gb:.1f} GB; {seen['calls']} logits calls, all finite "
        f"{seen['finite']}; launches {launches}; sample "
        f"{toks[0, :8].tolist()}")
    if not seen["finite"] or seen["calls"] != 33:
        raise AssertionError(f"qwen2-vl logits: {seen}")
    if launches["flash_attention"] < cfg.n_layers:
        raise AssertionError(f"flash forward launched "
                             f"{launches['flash_attention']} times")
    if peak_gb >= 80:
        raise AssertionError(f"peak device memory {peak_gb:.1f} GB")
    del toks
    gc.collect()
    torch.cuda.empty_cache()
    bundle = get_bundle(VLM_ARCH)
    params = bundle.init(torch.Generator(device=dev).manual_seed(SEED),
                         dtype=torch.bfloat16)
    n = sum(t.numel() for t in leaves(params))
    pf = bundle.make_batch("prefill", 4, 1024,
                           torch.Generator(device=dev).manual_seed(1))

    def window():
        with torch.inference_mode():
            c = bundle.init_caches(4, max_len=1024 + 9, n_chunks=1,
                                   device=dev)
            lg, c = bundle.prefill(params, pf, c)
            for i in range(8):
                lg, c = bundle.decode(params, c,
                                      serve.decode_batch(bundle, pf, None, i))

    busy = _profile(f"{VLM_ARCH} ({n / 1e9:.3f} B params bf16) 4 x 1024 "
                    f"prefill + 8 decode steps", window)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(tok_s=stats["tok_s"], peak_gb=peak_gb, busy=busy,
                          n_params=n)


def hybrid_train_phase(dev):
    """14 (d): phase 10's protocol run with zamba2-1.2b at full width,
    depth 12 (two shared-attention sites), through ``launch/train.py``;
    launches counted from 0 around the run; a two-step profiler window
    with the SSD scan's share."""
    from repro_torch.data.pipeline import token_stream
    from repro_torch.launch import train
    counters = _proto_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    run = train.main(HYBRID_TRAIN_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: c.launches for k, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    losses = [loss for _, loss in run.losses]
    warm = run.step_s[1:]
    cfg = run.bundle.cfg
    log(f"[hybrid-train] {cfg.name} full width (d_model {cfg.d_model}, "
        f"Mamba2 state {cfg.ssm_state}, 64 SSM heads of 64, the shared "
        f"block's 32 heads of 64 and d_ff {cfg.shared_attn_d_ff}), depth "
        f"{cfg.n_layers} of 38 (2 shared-attention sites; the full depth"
        f" would need ~70 GB of replicas before activations), P = "
        f"{run.n_params:,}, G = 4, f_w = 1 (ALIE x1), T = 5, "
        f"{PROTO_STEPS} steps of 4 x 1024 tokens per group: "
        f"{PROTO_STEPS / sum(run.step_s):.3f} steps/s over all steps, "
        f"{len(warm) / sum(warm):.3f} after the first (first "
        f"{run.step_s[0]:.2f} s, then {np.mean(warm):.3f} s each), "
        f"train.main wall {wall:.1f} s, peak device memory "
        f"{peak_gb:.1f} GB")
    log("[hybrid-train] loss per step " + json.dumps(
        [(i, round(x, 4)) for i, x in run.losses]))
    log("[hybrid-train] launches " + json.dumps(got) + " | per step "
        + json.dumps({k: round(v / PROTO_STEPS, 2)
                      for k, v in got.items()}))
    if not np.all(np.isfinite(losses)) or len(losses) != PROTO_STEPS:
        raise AssertionError(f"zamba2 losses not finite: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"zamba2 loss did not fall: {losses}")
    if peak_gb >= 80:
        raise AssertionError(f"peak device memory {peak_gb:.1f} GB")
    for k in ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv", "gram",
              "subset_diameters", "cwise_median"):
        if got[k] < PROTO_STEPS:
            raise AssertionError(f"{k} was launched {got[k]} times in "
                                 f"{PROTO_STEPS} zamba2 protocol steps")
    extra = list(token_stream(SEED + 1, cfg.vocab, 4, 4, 1024, 2,
                              device=dev))
    state = run.state

    def two_steps():
        nonlocal state
        for b in extra:
            state = run.step(state, b)

    busy, events, wall_us = _profile(f"protocol {cfg.name} depth 12, 2 "
                                     f"steps", two_steps, keep=True)
    sh = scan_share(events, "mamba2.ssd")
    dev_ms = (sh["fwd_device_us"] + sh["bwd_device_us"]) / 1e3
    log(f"[hybrid-train] the SSD scan in that window: {sh['calls']} "
        f"calls (forward and remat recompute), device {dev_ms:.1f} ms "
        f"(forward {sh['fwd_device_us'] / 1e3:.1f}, backward "
        f"{sh['bwd_device_us'] / 1e3:.1f}) = "
        f"{100 * dev_ms * 1e3 / wall_us:.1f} % of the wall, host "
        f"{sh['host_us'] / 1e3:.1f} ms = "
        f"{100 * sh['host_us'] / wall_us:.1f} % of the wall; "
        f"{sh['launches'] / 2:.0f} launches a step")
    del run, extra, state, events
    gc.collect()
    torch.cuda.empty_cache()
    return got, dict(peak_gb=peak_gb, busy=busy, scan=sh)


def _zipf_tokens(rng, vocab: int, shape, zipf: float = 1.2):
    """Tokens of a Zipf law over the vocabulary (the token stream's), drawn
    with numpy, so a model can learn their unigram statistics."""
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -zipf
    return rng.choice(vocab, size=shape, p=p / p.sum())


def audio_phase(dev):
    """14 (e): whisper-small at full width and depth. Serving through the
    bundle over ``max_source_len`` (1500) frames, a 64-token prompt and 32
    decode steps (the cross-attention's flash forward at Sq = 1 counted
    over the decode), then ``launch/serve.py --arch whisper-small``;
    training: 4 protocol steps through ``ProtocolEngine.run`` at G = 4,
    each group's batch 4 rows of 1024 frames and 1024 tokens from numpy,
    with the loss on a fixed batch after each step."""
    from repro_torch.core import protocol
    from repro_torch.core.attacks import ByzantineSpec
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import serve, train
    from repro_torch.models.registry import get_bundle
    from repro_torch.optim.schedules import inverse_linear
    from repro_torch.serve.replica import leaves
    bundle = get_bundle(AUDIO_ARCH)
    cfg = bundle.cfg
    rng = np.random.default_rng(SEED)
    B, Se, P0, N_DEC = 4, cfg.max_source_len, 64, 32
    frames = torch.from_numpy((0.5 * rng.standard_normal(
        (B, Se, cfg.d_model))).astype(np.float32)).to(dev)
    prompt = torch.from_numpy(_zipf_tokens(rng, cfg.vocab, (B, P0))).to(dev)
    params = bundle.init(torch.Generator(device=dev).manual_seed(SEED),
                         dtype=torch.bfloat16)
    n = sum(t.numel() for t in leaves(params))
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        c = bundle.init_caches(B, max_len=P0 + N_DEC + 1, n_chunks=1,
                               device=dev)
        t0 = time.perf_counter()
        lg, c = bundle.prefill(params, {"enc_frames": frames,
                                        "tokens": prompt}, c)
        torch.cuda.synchronize()
        t_pf = time.perf_counter() - t0
        finite = bool(torch.isfinite(lg).all())
        flash_ops.flash_attention.launches = 0
        t0 = time.perf_counter()
        for _ in range(N_DEC):
            lg, c = bundle.decode(params, c, {"token": lg.argmax(-1)[:, None]})
            finite &= bool(torch.isfinite(lg).all())
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
    cross = flash_ops.flash_attention.launches
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    log(f"[audio-serve] {cfg.name} full width and depth ({cfg.encoder_layers}"
        f" + {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads of {cfg.hd}, vocab {cfg.vocab}; {n / 1e9:.3f} B params bf16):"
        f" {B} x {Se} frames + {P0}-token prompt prefill {t_pf:.3f} s; "
        f"{N_DEC} decode steps {t_dec:.3f} s = {B * N_DEC / t_dec:.1f} tok/s;"
        f" cross K/V {tuple(c.cross_k.shape)}; flash forward launches over "
        f"the decode {cross} (cross-attention at Sq = 1 over {Se} frames, "
        f"{cfg.n_layers} a step); finite {finite}; peak device memory "
        f"{peak_gb:.1f} GB")
    if not finite:
        raise AssertionError("whisper-small: non-finite logits")
    if c.cross_k.shape[2] != Se or cross != cfg.n_layers * N_DEC:
        raise AssertionError(f"cross-attention: K/V {tuple(c.cross_k.shape)}"
                             f", {cross} flash launches over the decode")
    del params, c, lg
    gc.collect()
    torch.cuda.empty_cache()
    stats = {}
    toks = serve.main(["--arch", AUDIO_ARCH], stats=stats)
    log(f"[audio-serve] launch/serve.py --arch {AUDIO_ARCH} (4 x 32 frames "
        f"+ 32 tokens, 32 steps): {stats['tok_s']:.1f} tok/s; sample "
        f"{toks[0, :8].tolist()}")
    gc.collect()
    torch.cuda.empty_cache()

    # training: the protocol with G = 4 on frame batches
    G, rows, S = 4, 4, 1024
    pcfg = train.protocol_config(G, 5, byz=ByzantineSpec(
        worker_attack="alie", n_byz_workers=1))
    toks = _zipf_tokens(rng, cfg.vocab, (AUDIO_STEPS, G, rows, S + 1))
    batches = {
        "enc_frames": torch.from_numpy((0.5 * rng.standard_normal(
            (AUDIO_STEPS, G, rows, S, cfg.d_model))).astype(np.float32)
        ).to(dev),
        "tokens": torch.from_numpy(toks[..., :-1]).to(dev),
        "labels": torch.from_numpy(toks[..., 1:]).to(dev)}
    fixed = {k: v[0, 0] for k, v in batches.items()}

    def neg_loss(p, batch):
        return -bundle.loss(p, batch)

    eng = protocol.ProtocolEngine(
        bundle, pcfg, inverse_linear(AUDIO_LR, 0.005), with_attack=True,
        acc_fn=neg_loss, eval_set=(fixed,), device=dev)
    counters = _proto_counters()
    state = eng.init_state(SEED)
    torch.cuda.reset_peak_memory_stats(dev)
    for k in counters.values():
        k.launches = 0
    t0 = time.perf_counter()
    state, metrics = eng.run(state, batches, epoch_steps=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {k: c.launches for k, c in counters.items()}
    peak_gb_t = torch.cuda.max_memory_allocated(dev) / 1e9
    losses = [-float(a) for a in metrics["acc"]]
    log(f"[audio-train] {cfg.name} full width and depth, P = "
        f"{state.params.shape[1]:,}, G = {G}, f_w = 1 (ALIE x1), "
        f"{AUDIO_STEPS} protocol steps of {rows} x {S} frames + {S} Zipf "
        f"tokens per group, sgd {AUDIO_LR}: {AUDIO_STEPS / wall:.3f} steps/s "
        f"(wall {wall:.1f} s, the eval losses included), peak device memory "
        f"{peak_gb_t:.1f} GB; loss on a fixed batch after each step "
        f"{[round(x, 4) for x in losses]}; launches {json.dumps(got)}")
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"whisper losses: {losses}")
    if peak_gb_t >= 80:
        raise AssertionError(f"peak device memory {peak_gb_t:.1f} GB")
    for k in ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv", "gram",
              "subset_diameters"):
        if got[k] < AUDIO_STEPS:
            raise AssertionError(f"{k} was launched {got[k]} times in "
                                 f"{AUDIO_STEPS} whisper protocol steps")
    del state, batches, eng
    gc.collect()
    torch.cuda.empty_cache()
    launches = dict(got)
    launches["flash_attention"] += cross
    return launches, dict(tok_s=B * N_DEC / t_dec, peak_gb=max(peak_gb,
                                                               peak_gb_t),
                          train_steps_s=AUDIO_STEPS / wall)


def _zoo2_inputs(bundle, B: int, S: int):
    """A seeded batch of the family's inputs, float32 (vlm: embeddings and
    ``[3, B, S]`` ids whose components differ; audio: frames)."""
    rng = np.random.default_rng(SEED + 7)
    cfg = bundle.cfg
    toks = rng.integers(0, cfg.vocab, (B, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    if cfg.family == "vlm":
        batch["embeds"] = torch.from_numpy((0.5 * rng.standard_normal(
            (B, S, cfg.d_model))).astype(np.float32))
        batch["positions"] = torch.from_numpy(rng.integers(0, S, (3, B, S)))
        del batch["tokens"]
    if cfg.family == "audio":
        batch["enc_frames"] = torch.from_numpy((0.5 * rng.standard_normal(
            (B, 50, cfg.d_model))).astype(np.float32))
    return batch


def zoo2_reference_phase(dev):
    """14 (f): the three families reduced in float32, card against CPU:
    loss and every gradient, prefill and 3 decode steps (vlm fed embeds
    and M-RoPE ids); then zamba2 for 2T + 1 protocol steps as phase 9."""
    from repro_torch.launch import serve
    from repro_torch.models.registry import get_bundle
    from repro_torch.serve.replica import leaves, tree_map
    counters = _proto_counters()
    total = {k: 0 for k in counters}
    for arch in (VLM_ARCH, HYBRID_ARCH, AUDIO_ARCH):
        bundle = get_bundle(arch, reduced=True, act_dtype="float32")
        params = bundle.init(torch.Generator().manual_seed(SEED))
        batch = _zoo2_inputs(bundle, 2, 70)
        out = []
        for c in counters.values():
            c.launches = 0
        for d in (torch.device("cpu"), dev):
            p = tree_map(lambda t: t.detach().to(d).requires_grad_(), params)
            b = {k: v.to(d) for k, v in batch.items()}
            loss = bundle.loss(p, b)
            loss.backward()
            grads = [t.grad.flatten().cpu() for t in leaves(p)]
            with torch.inference_mode():
                pi = tree_map(lambda t: t.detach(), p)
                c = bundle.init_caches(2, max_len=80, n_chunks=4,
                                       dtype=torch.float32, device=d)
                pf = {k: v for k, v in b.items() if k != "labels"}
                lg, c = bundle.prefill(pi, pf, c)
                logits = [lg]
                for i in range(3):
                    lg, c = bundle.decode(pi, c, serve.decode_batch(
                        bundle, pf, lg.argmax(-1)[:, None], i))
                    logits.append(lg)
            out.append((loss.item(), torch.cat(grads),
                        torch.stack(logits).cpu()))
        for k, cnt in counters.items():
            total[k] += cnt.launches
        (l_cpu, g_cpu, lg_cpu), (l_card, g_card, lg_card) = out
        g_err = (g_card - g_cpu).abs().max().item()
        lg_err = (lg_card - lg_cpu).abs().max().item()
        log(f"[zoo2-ref] {arch} reduced f32 ({bundle.cfg.family}): loss card "
            f"{l_card:.6f} cpu {l_cpu:.6f}; max|grad diff| {g_err:.3g} "
            f"(max|grad| {g_cpu.abs().max().item():.3g}); prefill + 3 "
            f"decode max|logits diff| {lg_err:.3g}")
        if not (torch.isfinite(g_card).all()
                and torch.isfinite(lg_card).all()):
            raise AssertionError(f"{arch}: non-finite on the card")
        # float32 on both sides, sums in other orders (cuBLAS, the flash
        # kernels' tiles)
        if abs(l_card - l_cpu) > 1e-4:
            raise AssertionError(f"{arch}: loss {l_card} vs {l_cpu}")
        torch.testing.assert_close(g_card, g_cpu, rtol=1e-3,
                                   atol=1e-3 * g_cpu.abs().max().item())
        torch.testing.assert_close(lg_card, lg_cpu, rtol=1e-3, atol=1e-3)
    for c in counters.values():
        c.launches = 0
    protocol_reference_phase(dev, "lm/tfm_tiny", HYBRID_ARCH,
                             param_dtype="float32")
    for k, c in counters.items():
        total[k] += c.launches
    return total


# ---------------------------------------------------------------------------
# phase 15: the protocol over torch.distributed ranks
# ---------------------------------------------------------------------------

MESH_RANKS = 2          # (b): ranks sharing the card over gloo
# 1 step (3 before phase 16, 2 before phase 18 took its share of the
# script's time limit)
MESH_STEPS = 1
MESH_BUDGET_GB = 72.0   # what (b)'s ranks may take of the card together
# kernel rows 1-4, 7 and 8: every one runs on every rank each step
MESH_KERNELS = ("flash_attention", "flash_bwd_dq", "flash_bwd_dkv",
                "cwise_median", "gram", "subset_diameters")


def _host_available_gb() -> float:
    """The host's available memory (``MemAvailable``), GB."""
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _mesh_rank(rank: int, world: int, port: int, task: str, tmp: str):
    """One rank of phase 15 (b) or (c), spawned: joins a gloo world whose
    ranks share the card (the rule of ``repro_torch.device.dist_backend``),
    runs ``task`` and writes what it measured to ``tmp``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh
    dev = tmesh.init_distributed("cuda", rank=rank, world=world,
                                 init_method=f"tcp://localhost:{port}")
    try:
        counters = _proto_counters()
        for c in counters.values():
            c.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            out = RANK_TASKS[task](dev, rank, tmp)
        except BaseException:
            # this rank's own error, printed before its peers' lost
            # connections are
            import traceback
            free, card = torch.cuda.mem_get_info(dev)
            print(f"[mesh] {task} rank {rank} of {world} failed (card: "
                  f"{free / 1e9:.1f} of {card / 1e9:.1f} GB free, this "
                  f"rank's peak {torch.cuda.max_memory_allocated(dev) / 1e9:.1f}"
                  f" GB; host: {_host_available_gb():.1f} GB available):\n"
                  + traceback.format_exc(), file=sys.stderr, flush=True)
            raise
        torch.cuda.synchronize()
        out.update(launches={k: c.launches for k, c in counters.items()},
                   peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        with open(os.path.join(tmp, f"{task}_{rank}.json"), "w") as fh:
            json.dump(out, fh)
    finally:
        dist.destroy_process_group()


def _mesh_train_rank(dev, rank: int, tmp: str,
                     argv: str = "argv.json") -> dict:
    from repro_torch.launch import train
    with open(os.path.join(tmp, argv)) as fh:
        run = train.main(json.load(fh))
    mesh, split = run.state.mesh, run.state.split
    return dict(step_s=run.step_s, sent=run.sent, losses=run.losses,
                mesh=mesh.sizes, backend=mesh.backend, P=run.n_params,
                P_m=split.local.size if split else run.n_params)


def _mesh_tiny_rank(dev, rank: int, tmp: str, model: int = 1,
                    arch: str = "phi4-mini-3.8b", **over) -> dict:
    from repro_torch.launch import mesh as tmesh
    run = _tiny_protocol("lm/tfm_tiny", arch, **over)
    mesh = tmesh.make_protocol_mesh(run["pcfg"].n_groups, model=model)
    params, picked, wall = _tiny_run(run, dev, mesh)
    if rank == 0:
        name = "tiny" if arch == "phi4-mini-3.8b" else f"tiny_{arch}"
        torch.save(params, os.path.join(tmp, f"{name}_params.pt"))
    return dict(selections=[p.tolist() for p in picked], wall=wall,
                mesh=mesh.sizes, backend=mesh.backend)


def _spawn_ranks(task: str, world: int, tmp: str) -> list[dict]:
    """``world`` rank processes on the card (``torch.multiprocessing``,
    spawned); a rank that raises fails the phase."""
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    mp.start_processes(_mesh_rank, args=(world, _free_port(), task, tmp),
                       nprocs=world, start_method="spawn", join=True)
    log(f"[mesh] {task}: {world} ranks ran in {time.perf_counter() - t0:.1f}"
        f" s (their start included)")
    outs = []
    for r in range(world):
        with open(os.path.join(tmp, f"{task}_{r}.json")) as fh:
            outs.append(json.load(fh))
    return outs


def mesh_phase(dev, reference: dict) -> dict:
    """Phase 15: (a) phase 10's run through the mesh path on a world-1 NCCL
    group, against phase 10; (b) phi4-mini-3.8b at full width, depth 2, G
    = 4 on ranks sharing the card over gloo; (c) ``lm/tfm_tiny`` on 4 ranks
    (rep 4) on the card against the single-card CPU run. Returns the
    kernel launches of the three runs, by key."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.core.protocol import ProtocolConfig, \
        collective_volume_bytes
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import train
    total: dict = {}

    def add(got):
        for k in MESH_KERNELS:
            total[k] = total.get(k, 0) + got[k]

    # (a) ------------------------------------------------------------------
    t0 = time.perf_counter()
    tmesh.init_distributed("cuda", rank=0, world=1,
                           init_method=f"tcp://localhost:{_free_port()}")
    counters = _proto_counters()
    for c in counters.values():
        c.launches = 0
    try:
        with _selections() as picked:
            run = train.main(PROTO_ARGV)
        torch.cuda.synchronize()
        mesh = run.state.mesh
        got = {k: c.launches for k, c in counters.items()}
        fp = fingerprint(run.state.params)
        same = (len(picked) == len(reference["selections"]) == PROTO_STEPS
                and all(torch.equal(a > 0, b > 0) for a, b in
                        zip(picked, reference["selections"])))
        err = 0.0
        if fp != reference["fingerprint"]:
            host = reference["host"]
            for c0 in range(0, host.shape[1], 2**26):
                err = max(err, (run.state.params[:, c0:c0 + 2**26] - host[
                    :, c0:c0 + 2**26].to(dev)).abs().max().item())
    finally:
        dist.destroy_process_group()
    del run
    gc.collect()
    torch.cuda.empty_cache()
    add(got)
    log(f"[mesh] (a) phase 10's argv on a world-1 {mesh.backend} group, "
        f"mesh {mesh.sizes}: {time.perf_counter() - t0:.1f} s; params "
        f"bit-equal to phase 10: {fp == reference['fingerprint']}"
        + ("" if fp == reference["fingerprint"] else
           f" (max|diff| {err:.3g})")
        + f"; every MDA selection equal ({PROTO_STEPS} steps x 4 servers): "
        f"{same}; launches " + json.dumps(got))
    if mesh.backend != "nccl" or not same:
        raise AssertionError(f"phase 15 (a): backend {mesh.backend}, "
                             f"selections equal {same}")
    # the same tolerance as phase 9's card against CPU, at phase 10's scale
    if err > 1e-3:
        raise AssertionError(f"phase 15 (a): params differ by {err}")

    # (b) ------------------------------------------------------------------
    P, G, R = reference["P"], 4, MESH_RANKS
    stacks = G * P * (4 + 2 + 4)          # f32 replicas and grads, bf16 pull
    per_rank = reference["peak_gb"] * 1e9 - stacks + stacks / R
    batch = 4 if R * per_rank <= MESH_BUDGET_GB * 1e9 else 2
    log(f"[mesh] (b) reckoning from phase 10's peak "
        f"{reference['peak_gb']:.1f} GB, of it the [G, P] stacks "
        f"{stacks / 1e9:.1f} GB: a rank holds 1/{R} of the stacks, "
        f"{per_rank / 1e9:.1f} GB, {R} ranks {R * per_rank / 1e9:.1f} GB "
        f"against {MESH_BUDGET_GB:.0f} GB: "
        + ("4 x 1024 tokens a group, as phase 10" if batch == 4 else
           "cut to 2 x 1024 tokens a group (the width stays)"))
    argv = list(PROTO_ARGV)
    argv[argv.index("--steps") + 1] = str(MESH_STEPS)
    argv[argv.index("--batch-per-group") + 1] = str(batch)
    argv += ["--mesh", f"{R}x1"]
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "argv.json"), "w") as fh:
            json.dump(argv, fh)
        outs = _spawn_ranks("train", R, tmp)
    pcfg = ProtocolConfig.derive(G)
    model = collective_volume_bytes(pcfg, P, rep=R)
    for r, o in enumerate(outs):
        add(o["launches"])
        warm = o["step_s"][1:] or o["step_s"]
        scatter = [b.get("pull", 0) + b.get("aggregate", 0)
                   for b in o["sent"]]
        log(f"[mesh] (b) rank {r} of {R} ({o['backend']}, mesh "
            f"{o['mesh']}, P = {o['P']:,}): peak device memory "
            f"{o['peak_gb']:.1f} GB; {len(warm) / sum(warm):.4f} steps/s "
            + ("after the first " if len(o["step_s"]) > 1 else "")
            + f"(steps {[round(x, 2) for x in o['step_s']]}"
            f" s); bytes sent a step by tag {o['sent']} (gloo through the "
            f"host on one card: not a link's rate); pull + aggregate "
            f"{scatter} against collective_volume_bytes(rep={R}) {model}; "
            f"launches " + json.dumps(o["launches"]))
        if o["mesh"] != {"rep": R, "fsdp": 1, "model": 1} \
                or o["backend"] != "gloo":
            raise AssertionError(f"phase 15 (b) rank {r}: {o['mesh']}, "
                                 f"{o['backend']}")
        if any(abs(b - model) > 0.1 * model for b in scatter):
            raise AssertionError(f"phase 15 (b) rank {r}: {scatter} bytes "
                                 f"against the model's {model}")
        for k in MESH_KERNELS:
            if o["launches"][k] < MESH_STEPS:
                raise AssertionError(f"phase 15 (b) rank {r}: {k} launched "
                                     f"{o['launches'][k]} times in "
                                     f"{MESH_STEPS} steps")
    losses = [x for _, x in outs[0]["losses"]]
    log(f"[mesh] (b) losses (rank 0) {losses}; peak memory of the {R} ranks "
        f"together {sum(o['peak_gb'] for o in outs):.1f} GB")
    if len(losses) != MESH_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"phase 15 (b): losses {losses}")

    # (c) ------------------------------------------------------------------
    run = _tiny_protocol()
    with tempfile.TemporaryDirectory() as tmp:
        outs = _spawn_ranks("tiny", 4, tmp)
        ranks = torch.load(os.path.join(tmp, "tiny_params.pt"))
    cpu, sels, wall = _tiny_cpu(run)
    picked = [torch.tensor(p) for p in outs[0]["selections"]]
    for r, o in enumerate(outs):
        add(o["launches"])
        if o["mesh"] != {"rep": 4, "fsdp": 1, "model": 1} or any(
                not torch.equal(torch.tensor(p), q)
                for p, q in zip(o["selections"], picked)):
            raise AssertionError(f"phase 15 (c) rank {r}: mesh {o['mesh']}"
                                 ", or its selections differ from rank 0's")
    log(f"[mesh] (c) lm/tfm_tiny on 4 ranks ({outs[0]['backend']}, mesh "
        f"{outs[0]['mesh']}) {outs[0]['wall']:.1f} s, on the CPU {wall:.1f}"
        f" s; launches a rank " + json.dumps(outs[0]["launches"]))
    _tiny_compare(run, {"cpu": cpu, "ranks": ranks},
                  {"cpu": sels, "ranks": picked}, "mesh", "ranks")
    return total


# ---------------------------------------------------------------------------
# phase 16: the 'model' axis (tensor parallelism) over ranks on the card
# ---------------------------------------------------------------------------

TP_ARCH = "phi4-mini-3.8b"
# (a): the launcher's prefill and 8 decode steps, then phase 4's quorum run
TP_SERVE_ARGV = ["--arch", TP_ARCH, "--batch", "4", "--prefill", "1024",
                 "--decode", "8"]
TP_LOGIT_TOL = 2e-2     # rel-L2 of (a)'s prefill logits, model 2 vs one rank
# (a)'s quorum run: 4 requests x 8 new tokens (phase 4's 8 x 16 until phase
# 18 took its share of the script's time limit: 58 s at 2.2 tok/s a rank)
TP_REQUESTS, TP_NEW = 4, 8
# (b): depth, steps and tokens reckoned from the bytes a rank moves a step,
# at the gloo rate of 8 ranks sharing one H100 80GB HBM3 (700 W) and its
# host (a second step of depth 1 moved 9.72 GB a rank in 19.1 s: 0.51
# GB/s; phase 15 (b): 0.51-0.65 GB/s a rank with 2), within a time budget
TP_RATE = 0.5e9
# (40 s: 45 until phase 18 took its share of the script's time limit)
TP_BUDGET_S = 40.0
TP_MEM_GB = 72.0        # what (b)'s 8 ranks may take of the card together
TP_SEQ = 512
# one step of phase 10's lr 0.002 overshoots at this width (its loss rises
# at step 1): a smaller one keeps a few steps' losses falling
TP_LR = "0.0005"


def _bf16_spread(dev, want) -> float:
    """A yardstick for 16 (a): the launcher's weights and prompts (seeds 0
    and 1) prefilled on one card with float32 activations, against
    ``want``, the bf16 batch's last-token logits (rel-L2): how far bf16
    arithmetic itself moves these logits."""
    import dataclasses

    from repro_torch.models.registry import ModelBundle, get_bundle
    bundle = ModelBundle(dataclasses.replace(get_bundle(TP_ARCH).cfg,
                                             act_dtype="float32"))
    params = bundle.init(torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16)
    pf = bundle.make_batch("prefill", 4, 1024,
                           torch.Generator(device=dev).manual_seed(1))
    caches = bundle.init_caches(4, max_len=1025, n_chunks=1, device=dev)
    got = bundle.prefill(params, pf, caches)[0].float().cpu()
    del params, caches
    return ((got - want).norm() / want.norm()).item()


def _tp_serve_rank(dev, rank: int, tmp: str) -> dict:
    """16 (a) on one rank of the (1, 2) serve mesh: ``launch/serve.py
    --mesh 1x2``, then phase 4's quorum run, each one's launches counted
    from 0, and then its honest replica, not counted."""
    from repro_torch.core.attacks import ByzantineSpec
    from repro_torch.core.simulator import FlatTree
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import serve, steps
    from repro_torch.models.registry import get_bundle
    from repro_torch.serve import QuorumService, ReplicaPool
    from repro_torch.serve.replica import tree_map
    counters = _proto_counters()
    stats: dict = {}
    _zero_counts(counters)
    t0 = time.perf_counter()
    ids = serve.main(TP_SERVE_ARGV + ["--mesh", "1x2"], stats=stats)
    launcher = _read_counts(counters)
    launcher_s = time.perf_counter() - t0
    if rank == 0:
        torch.save(stats["logits"], os.path.join(tmp, "tp_logits.pt"))
    bundle = get_bundle(TP_ARCH)
    cfg = bundle.cfg
    smesh = tmesh.make_serve_mesh(tmesh.make_mesh((1, 2), ("data", "model")))
    rules = steps.serve_rules(smesh, cfg)
    with torch.inference_mode():
        params = bundle.init(torch.Generator(device=dev).manual_seed(SEED),
                             dtype=torch.bfloat16)
        specs = steps.serve_param_sharding(FlatTree.from_params(params),
                                           smesh, cfg)
        pool = ReplicaPool.from_params(params, N_REPLICAS, f=F_BYZ).shard(
            specs, smesh)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        honest = ReplicaPool(params=tree_map(lambda l: l[:1], pool.params),
                             f=0, sharded=True)
        pool = pool.corrupt(ByzantineSpec(server_attack="reversed",
                                          n_byz_servers=1))
        rng = np.random.default_rng(SEED)
        lens = rng.integers(64, 1025, size=TP_REQUESTS)
        prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
        kw = dict(n_slots=N_SLOTS, n_chunks=4, rule="median", rules=rules,
                  max_len=-(-(int(lens.max()) + TP_NEW + 1) // 64) * 64)
        svc = QuorumService(pool, bundle, **kw)
        _zero_counts(counters)
        t0 = time.perf_counter()
        outs = svc.generate(prompts, max_new=TP_NEW)
        quorum = _read_counts(counters)
        wall = time.perf_counter() - t0
        rep = svc.report()
        base = QuorumService(honest, bundle, **kw).generate(prompts,
                                                            max_new=TP_NEW)
    return dict(ids=ids.tolist(), launcher_s=launcher_s,
                launcher_launches=launcher, quorum_launches=quorum,
                prefill_s=stats["prefill_s"], tok_s_launcher=stats["tok_s"],
                quorum=outs, honest=base, ejections=rep["ejections"],
                wall=wall, tok_s=rep["tok_s"], mesh=smesh.sizes,
                backend=smesh.backend, sent=dict(smesh.sent),
                w_gate=list(svc.pool.params["blocks"]["mlp"]["w_gate"]
                            .shape))


def _tp_train_rank(dev, rank: int, tmp: str) -> dict:
    """16 (b), then (c) in the same 8 ranks (one start for both): each
    part's launches counted from 0, its peak memory from a reset."""
    counters = _proto_counters()
    out = {}
    parts = [("train", _mesh_train_rank),
             ("tiny", lambda *a: _mesh_tiny_rank(*a, model=2))]
    if os.path.exists(os.path.join(tmp, "argv_zoo.json")):
        # phase 17 (c) and (d) on the same ranks
        parts += [("zoo_train", lambda *a: _mesh_train_rank(
                      *a, argv="argv_zoo.json"))]
        parts += [(f"tiny_{arch}", lambda *a, arch=arch: _mesh_tiny_rank(
                      *a, model=2, arch=arch, param_dtype="float32"))
                  for arch in TP_ZOO_TINY]
    for part, fn in parts:
        for c in counters.values():
            c.launches = 0
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out[part] = fn(dev, rank, tmp)
        torch.cuda.synchronize()
        out[part].update(
            launches={k: c.launches for k, c in counters.items()},
            peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
            part_s=time.perf_counter() - t0)
    return out


RANK_TASKS = {"train": _mesh_train_rank, "tiny": _mesh_tiny_rank,
              "tp_serve": _tp_serve_rank, "tp_train": _tp_train_rank,
              "tp_zoo_serve": lambda *a: _tp_zoo_serve_rank(*a)}


def _rank_peak(cfg, pcfg, batch: int, rank: int = 1) -> dict:
    """The dry run (``repro_torch.launch.dryrun.measure`` on meta tensors)
    of one step of ``launch/train.py --mesh 4x2`` at ``cfg``, ``batch``
    rows of ``TP_SEQ`` tokens a group, for ``rank`` of the (4, 1, 2) mesh
    (a 'model' coordinate 1 also holds its owned-columns mask): its
    figures, the bytes it sends by tag among them."""
    from repro_torch.core import protocol
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models.registry import ModelBundle
    from repro_torch.optim.schedules import inverse_linear
    bundle = ModelBundle(cfg)
    view = tmesh.RankView(tmesh.AXES, (4, 1, 2), rank=rank)
    state = protocol.make_init_fn(bundle, pcfg, "meta", view)(0)
    step = protocol.make_train_step(bundle, pcfg,
                                    inverse_linear(float(TP_LR), 0.005),
                                    mesh=view)
    G = pcfg.n_groups
    toks = torch.empty((G, batch, TP_SEQ), dtype=torch.long, device="meta")
    fig, _ = dryrun.measure(step, (state, {"tokens": toks, "labels": toks}),
                            view)
    return fig


def _tp_reckon(pcfg, cfg, cands, budget_s: float, label: str):
    """The depth, steps and rows of ``TP_SEQ`` tokens a group of a run of
    ``cfg`` through ``launch/train.py --mesh 4x2``: the first of ``cands``
    (or the last) whose bytes a rank a step at ``TP_RATE`` fit
    ``budget_s`` and whose 8 ranks fit ``TP_MEM_GB`` of the card, each
    reckoned and printed after ``label``. A rank's memory: the larger of
    its draw of the whole f32 model beside its block and its step's peak
    as the dry run reckons it (:func:`_rank_peak`), a fifth more for the
    allocator's fragments, and 1 GB for its CUDA context."""
    import dataclasses

    from repro_torch.core import protocol
    from repro_torch.core.simulator import FlatTree
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models.registry import ModelBundle
    mesh = tmesh.Mesh(tmesh.AXES, (4, 1, 2))
    peaks: dict = {}
    for depth, steps, batch in cands:
        c = dataclasses.replace(cfg, n_layers=depth)
        tree = FlatTree.from_params(ModelBundle(c).meta_params())
        P_m = protocol.model_split(c, tree, mesh).local.size
        scatter = protocol.collective_volume_bytes(pcfg, P_m)
        gram = 3 * -(-P_m // 4) * 4
        tp = sum(protocol.model_volume_bytes(c, 2, batch * TP_SEQ).values())
        step_b = scatter + gram + tp
        secs = steps * step_b / TP_RATE
        if (depth, batch) not in peaks:
            peaks[depth, batch] = _rank_peak(c, pcfg, batch)["memory"][
                "peak_bytes"]
        peak = peaks[depth, batch]
        rank_b = max(4 * tree.size + 4 * P_m, peak)
        mem = 8 * (1.2 * rank_b + 1e9)
        log(f"{label} reckoning {cfg.name} depth {depth}, {steps} steps, "
            f"{batch} x {TP_SEQ} tokens: P = {tree.size:,}, a rank's blocks "
            f"P_m = {P_m:,}; a step sends pull + aggregate "
            f"{scatter / 1e9:.2f} GB (collective_volume_bytes), the Gram's "
            f"all-to-all {gram / 1e9:.2f} GB, the 'model' tags "
            f"{tp / 1e9:.3f} GB: {step_b / 1e9:.2f} GB, {secs:.0f} s at "
            f"{TP_RATE / 1e9:.2f} GB/s a rank (budget {budget_s:.0f} s); a "
            f"rank's step peaks at {peak / 1e9:.2f} GB (dry run), its draw "
            f"at {(4 * tree.size + 4 * P_m) / 1e9:.2f} GB; 8 ranks "
            f"{mem / 1e9:.1f} GB (budget {TP_MEM_GB:.0f} GB)")
        if secs <= budget_s and mem <= TP_MEM_GB * 1e9 \
                or (depth, steps, batch) == cands[-1]:
            return depth, steps, batch


def tp_phase(dev, parts: str = "ab", zoo: bool = True) -> dict:
    """Phase 16: the 'model' axis on ranks sharing the card over gloo. (a)
    phi4-mini-3.8b at full width and depth, random bf16 weights, through
    ``launch/serve.py --mesh 1x2``: the prefill logits against the
    single-card launcher's (rel-L2 under ``TP_LOGIT_TOL``), then phase 4's
    quorum run at model 2 token-identical to the honest replica on the
    same mesh, replica 3 ejected, the flash forward and the median
    launched on each rank. (b) phi4-mini-3.8b at full width, G = 4,
    through ``launch/train.py --mesh 4x2`` (8 ranks: rep 4, model 2), its
    depth, steps and tokens reckoned first: finite, falling losses; each
    step's pull + aggregate equal to ``collective_volume_bytes`` on the
    rank's blocks, the 'model' tags equal to ``model_volume_bytes``; rows
    1-4, 7 and 8 launched each step. (c) ``lm/tfm_tiny`` at (rep 4, fsdp 1,
    model 2) on 8 ranks against the single-card CPU run: every MDA
    selection equal; (b) and (c) share one start of 8 ranks, and with
    ``zoo`` phase 17 (c) and (d) run on the same ranks after them (their
    gates are :func:`tp_zoo_phase`'s). Returns the kernel launches of the
    runs; ``parts`` names the parts to run, ``a`` and ``b`` (with (c));
    ``tools/tp_phase.py`` runs them alone."""
    import tempfile

    from repro_torch.core.protocol import (collective_volume_bytes,
                                           model_volume_bytes)
    from repro_torch.launch import serve, train
    from repro_torch.models.registry import get_bundle
    total: dict = {}

    def add(got):
        for k in MESH_KERNELS:
            total[k] = total.get(k, 0) + got.get(k, 0)

    # (a) ------------------------------------------------------------------
    if "a" in parts:
        t0 = time.perf_counter()
        stats: dict = {}
        with torch.inference_mode():
            ids1 = serve.main(TP_SERVE_ARGV, stats=stats)
            spread = _bf16_spread(dev, stats["logits"])
        want = stats["logits"]
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            outs = _spawn_ranks("tp_serve", 2, tmp)
            got = torch.load(os.path.join(tmp, "tp_logits.pt"))
        rel = ((got - want).norm() / want.norm()).item()
        mx = (got - want).abs().max().item()
        same_tok = int((got.argmax(-1) == want.argmax(-1)).sum())
        o = outs[0]
        log(f"[tp] (a) {TP_ARCH} full width and depth, bf16, "
            f"launch/serve.py --mesh 1x2 ({o['backend']}, mesh "
            f"{o['mesh']}): prefill 4 x 1024 in {o['prefill_s']:.2f} s "
            f"(one rank: {stats['prefill_s']:.2f} s), decode "
            f"{o['tok_s_launcher']:.2f} tok/s (one rank: "
            f"{stats['tok_s']:.2f}); prefill logits against the single "
            f"card: rel-L2 {rel:.3e} (gate {TP_LOGIT_TOL}; one card's bf16 "
            f"against its float32 activations: {spread:.3e}), max|diff| "
            f"{mx:.4g} (max|logit| {want.abs().max().item():.4g}), greedy "
            f"token equal in {same_tok} of {want.shape[0]} rows; decoded "
            f"ids equal to the single card's: {o['ids'] == ids1.tolist()}")
        if rel > TP_LOGIT_TOL or not torch.isfinite(got).all():
            raise AssertionError(f"phase 16 (a): prefill logits rel-L2 "
                                 f"{rel}")
        for r, o in enumerate(outs):
            add(o["launcher_launches"])
            add(o["quorum_launches"])
            log(f"[tp] (a) rank {r}: quorum run {o['wall']:.2f} s "
                f"({o['tok_s']:.2f} tok/s), ejections {o['ejections']}, peak "
                f"device memory {o['peak_gb']:.1f} GB, w_gate block "
                f"{o['w_gate']}, bytes sent by tag {o['sent']}; launches "
                f"of the launcher {json.dumps(o['launcher_launches'])}, of "
                f"the quorum run {json.dumps(o['quorum_launches'])}")
            if o["quorum"] != o["honest"] or \
                    o["quorum"] != outs[0]["quorum"]:
                raise AssertionError(f"phase 16 (a) rank {r}: the quorum "
                                     "run differs from the honest replica")
            if [i for _, i in o["ejections"]] != [N_REPLICAS - 1]:
                raise AssertionError(f"phase 16 (a) rank {r}: ejections "
                                     f"{o['ejections']}")
            if o["launcher_launches"]["flash_attention"] <= 0 or any(
                    o["quorum_launches"][k] <= 0
                    for k in ("flash_attention", "cwise_median")):
                raise AssertionError(f"phase 16 (a) rank {r}: the flash "
                                     "forward or the median not launched")
        log(f"[tp] (a) token-identical to the honest replica on the mesh "
            f"({TP_REQUESTS} requests x {TP_NEW} tokens), replica "
            f"{N_REPLICAS - 1} ejected: {time.perf_counter() - t0:.1f} s")

    # (b) and (c): one start of 8 ranks -------------------------------------
    if "b" in parts:
        t0 = time.perf_counter()
        cfg = get_bundle(TP_ARCH).cfg
        G = 4
        pcfg = train.protocol_config(G, 5)
        depth, steps, batch = _tp_reckon(
            pcfg, cfg, [(d, s, b) for d in (2, 1) for s in (3, 2)
                        for b in (4, 2, 1)], TP_BUDGET_S, "[tp] (b)")
        argv = ["--arch", TP_ARCH, "--depth", str(depth), "--groups", str(G),
                "--T", "5", "--seq", str(TP_SEQ), "--batch-per-group",
                str(batch), "--steps", str(steps), "--lr", TP_LR,
                "--log-every", "1", "--mesh", "4x2"]
        free, card = torch.cuda.mem_get_info(dev)
        log(f"[tp] (b) launch/train.py {' '.join(argv)}; the card has "
            f"{free / 1e9:.1f} of {card / 1e9:.1f} GB free (this process "
            f"holds {torch.cuda.memory_reserved(dev) / 1e9:.1f} GB)")
        run = _tiny_protocol()
        zoo_argv = _tp_zoo_train_argv(pcfg) if zoo else None
        with tempfile.TemporaryDirectory() as tmp:
            with open(os.path.join(tmp, "argv.json"), "w") as fh:
                json.dump(argv, fh)
            if zoo:
                with open(os.path.join(tmp, "argv_zoo.json"), "w") as fh:
                    json.dump(zoo_argv["argv"], fh)
            outs = _spawn_ranks("tp_train", 8, tmp)
            ranks = torch.load(os.path.join(tmp, "tiny_params.pt"))
            if zoo:
                TP_ZOO_RANKS.update(outs=outs, **zoo_argv, tiny={
                    arch: torch.load(os.path.join(
                        tmp, f"tiny_{arch}_params.pt"))
                    for arch in TP_ZOO_TINY})
        import dataclasses
        c = dataclasses.replace(cfg, n_layers=depth)
        TP_TRAIN_RANKS.update(outs=outs, cfg=c, pcfg=pcfg, batch=batch)
        tp_want = model_volume_bytes(c, 2, batch * TP_SEQ)
        for r, o in enumerate(o["train"] for o in outs):
            add(o["launches"])
            exact = collective_volume_bytes(pcfg, o["P_m"])
            model = collective_volume_bytes(pcfg, o["P"], model=2)
            warm = o["step_s"][1:] or o["step_s"]
            scatter = [b.get("pull", 0) + b.get("aggregate", 0)
                       for b in o["sent"]]
            log(f"[tp] (b) rank {r} of 8 ({o['backend']}, mesh "
                f"{o['mesh']}, P = {o['P']:,}, P_m = {o['P_m']:,}): peak "
                f"device memory {o['peak_gb']:.1f} GB; "
                f"{len(warm) / sum(warm):.4f} steps/s after the first "
                f"(steps {[round(x, 2) for x in o['step_s']]} s); bytes a "
                f"step by tag {o['sent']}; pull + aggregate "
                f"{scatter} against collective_volume_bytes(n_params=P_m) "
                f"{exact} (model=2: {model}); the 'model' tags' formula "
                f"{tp_want}; launches " + json.dumps(o["launches"]))
            if o["mesh"] != {"rep": 4, "fsdp": 1, "model": 2}:
                raise AssertionError(f"phase 16 (b) rank {r}: {o['mesh']}")
            if any(b != exact for b in scatter):
                raise AssertionError(f"phase 16 (b) rank {r}: {scatter} "
                                     f"bytes against {exact}")
            for sent in o["sent"]:
                for tag, n in tp_want.items():
                    if sent.get(tag) != n:
                        raise AssertionError(f"phase 16 (b) rank {r}: {tag} "
                                             f"{sent.get(tag)} against {n}")
            for k in MESH_KERNELS:
                if o["launches"][k] < steps:
                    raise AssertionError(
                        f"phase 16 (b) rank {r}: {k} launched "
                        f"{o['launches'][k]} times in {steps} steps")
        losses = [x for _, x in outs[0]["train"]["losses"]]
        log(f"[tp] (b) losses (rank 0) {losses}; peak memory of the 8 ranks "
            f"together {sum(o['train']['peak_gb'] for o in outs):.1f} GB")
        if (len(losses) != steps or not np.all(np.isfinite(losses))
                or not losses[-1] < losses[0]):
            raise AssertionError(f"phase 16 (b): losses {losses}")
        # (c) on the same ranks
        cpu, sels, wall = _tiny_cpu(run)
        picked = [torch.tensor(p) for p in outs[0]["tiny"]["selections"]]
        for r, o in enumerate(o["tiny"] for o in outs):
            add(o["launches"])
            if o["mesh"] != {"rep": 4, "fsdp": 1, "model": 2} or any(
                    not torch.equal(torch.tensor(p), q)
                    for p, q in zip(o["selections"], picked)):
                raise AssertionError(f"phase 16 (c) rank {r}: mesh "
                                     f"{o['mesh']}, or its selections "
                                     "differ from rank 0's")
        o = outs[0]["tiny"]
        log(f"[tp] (c) lm/tfm_tiny on 8 ranks ({o['backend']}, mesh "
            f"{o['mesh']}) {o['wall']:.1f} s, on the CPU {wall:.1f} s; "
            f"launches a rank " + json.dumps(o["launches"]))
        _tiny_compare(run, {"cpu": cpu, "ranks": ranks},
                      {"cpu": sels, "ranks": picked}, "tp", "ranks")
        log(f"[tp] (b) and (c): {time.perf_counter() - t0:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 17: the 'model' axis for the MoE, hybrid, RWKV6 and audio families
# ---------------------------------------------------------------------------

# (a): launch/serve.py at full width, one card against --mesh 1x2: (arch,
# depth (None: the arch's), launcher argv); qwen3-moe at phase 13's serving
# depth, whisper-small over 1500 encoder frames (its prefill's tokens are
# half the batch's S)
TP_ZOO = (
    (MOE_ARCH, 2, ["--batch", "2", "--prefill", "512", "--decode", "8"]),
    (RWKV_ARCH, None, ["--batch", "2", "--prefill", "512", "--decode", "8"]),
    (HYBRID_ARCH, None, ["--batch", "2", "--prefill", "512", "--decode",
                         "8"]),
    (AUDIO_ARCH, None, ["--batch", "2", "--prefill", "3000", "--decode",
                        "8"]),
)
# (b): quorum serving at model 2 at these depths (rwkv6-3b and zamba2-1.2b
# cut to a quarter and a third: their full depth is (a)'s, and a quorum run
# decodes each replica and slot alone, ~30 s of the script's limit at full
# depth over gloo): 4 replicas (replica 3 reversed), these requests of at
# most this many prompt tokens, this many new tokens each
TP_ZOO_QUORUM = {MOE_ARCH: 2, RWKV_ARCH: 8, HYBRID_ARCH: 12}
# (a)'s gates: the split's prefill logits against one card's with float32
# activations within TP_ZOO_F32_TOL (rel-L2; 4.1e-6 to 3.2e-5 measured on
# one H100 80GB HBM3, 700 W: the split's float32 summation order, so a
# fault that moves the logits by a part in a thousand fails); with bf16
# within TP_ZOO_SPREAD_X times bf16's own spread (one card's bf16 logits
# against its float32 ones), a looser yardstick: with random weights at
# full depth bf16 alone moves these logits by 2.4e-2 (qwen3-moe), 1.7e-1
# (rwkv6-3b), 4.9e-2 (zamba2-1.2b) and 8.6e-3 (whisper-small) on that card
TP_ZOO_F32_TOL = 1e-3
TP_ZOO_SPREAD_X = 2.0
TP_ZOO_REQUESTS, TP_ZOO_PROMPT, TP_ZOO_NEW = 2, 256, 8
# (c): zamba2-1.2b through launch/train.py --mesh 4x2, its depth and tokens
# reckoned as 16 (b)'s, 2 steps, within this time budget
TP_ZOO_BUDGET_S = 40.0
# (d): the reduced families card against CPU on 16 (b)'s ranks
TP_ZOO_TINY = (MOE_ARCH, HYBRID_ARCH)
TP_ZOO_RANKS: dict = {}


def _zoo_argv(arch: str, depth, argv: list) -> list:
    return ["--arch", arch] + argv + ([] if depth is None
                                      else ["--depth", str(depth)])


def _tp_zoo_train_argv(pcfg) -> dict:
    """17 (c)'s argv: zamba2-1.2b at full width, G = 4, ``launch/train.py
    --mesh 4x2``, 2 steps, its depth (whole shared-block periods: 12, then
    6) and rows of ``TP_SEQ`` tokens reckoned as 16 (b)'s are, within
    ``TP_ZOO_BUDGET_S``."""
    import dataclasses

    from repro_torch.models.registry import get_bundle
    cfg = get_bundle(HYBRID_ARCH).cfg
    depth, steps, batch = _tp_reckon(
        pcfg, cfg, [(d, 2, b) for d in (12, 6) for b in (2, 1)],
        TP_ZOO_BUDGET_S, "[tp-zoo] (c)")
    argv = ["--arch", HYBRID_ARCH, "--depth", str(depth), "--groups", "4",
            "--T", "5", "--seq", str(TP_SEQ), "--batch-per-group",
            str(batch), "--steps", str(steps), "--lr", TP_LR, "--log-every",
            "1", "--mesh", "4x2"]
    return {"argv": argv, "cfg": dataclasses.replace(cfg, n_layers=depth),
            "steps": steps, "tokens": batch * TP_SEQ, "pcfg": pcfg}


def _tp_zoo_quorum(dev, arch: str, depth, counters) -> dict:
    """17 (b) on one rank of the (1, 2) serve mesh: the quorum run of 4
    replicas (replica 3 reversed), its launches counted from 0, and then
    the honest replica's, not counted."""
    from repro_torch.core.attacks import ByzantineSpec
    from repro_torch.core.simulator import FlatTree
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import steps
    from repro_torch.models.registry import get_bundle
    from repro_torch.serve import QuorumService, ReplicaPool
    from repro_torch.serve.replica import tree_map
    bundle = get_bundle(arch, depth=depth)
    cfg = bundle.cfg
    smesh = tmesh.make_serve_mesh(tmesh.make_mesh((1, 2), ("data", "model")))
    rules = steps.serve_rules(smesh, cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        params = bundle.init(torch.Generator(device=dev).manual_seed(SEED),
                             dtype=torch.bfloat16)
        specs = steps.serve_param_sharding(FlatTree.from_params(params),
                                           smesh, cfg)
        pool = ReplicaPool.from_params(params, N_REPLICAS, f=F_BYZ).shard(
            specs, smesh)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        honest = ReplicaPool(params=tree_map(lambda l: l[:1], pool.params),
                             f=0, sharded=True)
        pool = pool.corrupt(ByzantineSpec(server_attack="reversed",
                                          n_byz_servers=1))
        rng = np.random.default_rng(SEED)
        lens = rng.integers(64, TP_ZOO_PROMPT + 1, size=TP_ZOO_REQUESTS)
        prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
        kw = dict(n_slots=TP_ZOO_REQUESTS, n_chunks=4, rule="median",
                  rules=rules,
                  max_len=-(-(int(lens.max()) + TP_ZOO_NEW + 1) // 64) * 64)
        svc = QuorumService(pool, bundle, **kw)
        _zero_counts(counters)
        t0 = time.perf_counter()
        outs = svc.generate(prompts, max_new=TP_ZOO_NEW)
        launches = _read_counts(counters)
        wall = time.perf_counter() - t0
        rep = svc.report()
        base = QuorumService(honest, bundle, **kw).generate(
            prompts, max_new=TP_ZOO_NEW)
    return dict(quorum=outs, honest=base, ejections=rep["ejections"],
                quorum_launches=launches,
                quorum_s=wall, quorum_tok_s=rep["tok_s"],
                quorum_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                prompt_lens=lens.tolist())


def _tp_zoo_serve_rank(dev, rank: int, tmp: str) -> dict:
    """17 (a) and (b) on one rank of the (1, 2) serve mesh: each model
    through ``launch/serve.py --mesh 1x2`` (its launches counted from 0),
    its float32-activation prefill on the same split (not counted), then
    its quorum run."""
    from repro_torch.launch import mesh as tmesh
    from repro_torch.launch import serve
    counters = _proto_counters()
    out = {}
    for arch, depth, argv in TP_ZOO:
        stats: dict = {}
        _zero_counts(counters)
        t0 = time.perf_counter()
        ids = serve.main(_zoo_argv(arch, depth, argv) + ["--mesh", "1x2"],
                         stats=stats)
        rec = dict(ids=ids.tolist(), launches=_read_counts(counters),
                   launcher_s=time.perf_counter() - t0,
                   prefill_s=stats["prefill_s"], tok_s=stats["tok_s"])
        smesh = tmesh.make_serve_mesh(tmesh.make_mesh((1, 2),
                                                      ("data", "model")))
        f32 = _f32_logits(dev, arch, depth, argv, smesh)
        if rank == 0:
            torch.save({"bf16": stats["logits"], "f32": f32},
                       os.path.join(tmp, f"zoo_logits_{arch}.pt"))
        gc.collect()
        torch.cuda.empty_cache()
        if arch in TP_ZOO_QUORUM:
            rec.update(_tp_zoo_quorum(dev, arch, TP_ZOO_QUORUM[arch],
                                      counters))
            gc.collect()
            torch.cuda.empty_cache()
        out[arch] = rec
    return out


def _f32_logits(dev, arch: str, depth, argv: list, smesh=None):
    """A ``TP_ZOO`` entry's weights and batch as the launcher draws them
    (seeds 0 and 1; bf16 weights) prefilled with float32 activations: on
    one card, or split over ``smesh``'s 'model' ranks (the launcher's
    blocks and rule table). Returns the last-token logits, joined over
    the vocab, on the host."""
    import dataclasses

    from repro_torch.launch import serve, steps
    from repro_torch.models import layers as L
    from repro_torch.models import sharding as shr
    from repro_torch.models.registry import ModelBundle, get_bundle
    B, S = (int(argv[argv.index(k) + 1]) for k in ("--batch", "--prefill"))
    bundle = ModelBundle(dataclasses.replace(
        get_bundle(arch, depth=depth).cfg, act_dtype="float32"))
    params = bundle.init(torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16)
    pf = bundle.make_batch("prefill", B, S,
                           torch.Generator(device=dev).manual_seed(1))
    rules, M = None, 1
    if smesh is not None:
        params = serve._cut_params(params, smesh, bundle.cfg)
        rules, M = steps.serve_rules(smesh, bundle.cfg), smesh.size("model")
    with torch.inference_mode(), shr.sharding_rules(rules):
        caches = bundle.init_caches(B, max_len=S + 2, n_chunks=M,
                                    device=dev)
        got = L.gather_vocab(bundle.prefill(params, pf, caches)[0])
    return got.float().cpu()


def _rel(a, b) -> float:
    return ((a - b).norm() / b.norm()).item()


def tp_zoo_phase(dev, parts: str = "ab") -> dict:
    """Phase 17: the 'model' axis for the MoE, hybrid, RWKV6 and audio
    families on ranks sharing the card over gloo. (a) qwen3-moe-235b-a22b
    at phase 13's serving depth (2 of 94), rwkv6-3b and zamba2-1.2b at
    full depth and whisper-small over 1500 encoder frames, random bf16
    weights at full width, through ``launch/serve.py --mesh 1x2``: the
    prefill logits against the single card's (float32 activations within
    ``TP_ZOO_F32_TOL`` rel-L2, bf16 within ``TP_ZOO_SPREAD_X`` times one
    card's bf16 against its float32 activations), decode tok/s; (b) a quorum run at model 2 for the first
    three (at the depths of ``TP_ZOO_QUORUM``): 4 replicas with replica 3
    reversed, token-identical to the honest replica on the mesh, replica
    3 ejected, tok/s and GB a rank;
    (a) and (b) share one start of 2 ranks. (c) zamba2-1.2b at full width
    through ``launch/train.py --mesh 4x2`` (depth and tokens reckoned), 2
    steps: finite losses, each rank's bytes equal to
    ``collective_volume_bytes`` and ``model_volume_bytes``; (d) the reduced
    MoE and hybrid in f32 at (rep 4, fsdp 1, model 2) against the CPU,
    every MDA selection equal. (c) and (d) run on phase 16 (b)'s ranks
    (``tp_phase(..., zoo=True)``), and are checked here when that ran.
    Returns the kernel launches of the runs and the phase's seconds."""
    import tempfile

    from repro_torch.core.protocol import (collective_volume_bytes,
                                           model_volume_bytes)
    from repro_torch.launch import serve
    total: dict = {}
    t0 = time.perf_counter()

    def add(got):
        for k, v in got.items():
            total[k] = total.get(k, 0) + v

    # (a) and (b) ------------------------------------------------------------
    if "a" in parts:
        one = {}
        for arch, depth, argv in TP_ZOO:
            stats: dict = {}
            with torch.inference_mode():
                serve.main(_zoo_argv(arch, depth, argv), stats=stats)
                gc.collect()
                torch.cuda.empty_cache()
                f32 = _f32_logits(dev, arch, depth, argv)
            one[arch] = dict(stats, f32=f32,
                             spread=_rel(stats["logits"], f32))
            gc.collect()
            torch.cuda.empty_cache()
        failed = []
        with tempfile.TemporaryDirectory() as tmp:
            outs = _spawn_ranks("tp_zoo_serve", 2, tmp)
            got = {arch: torch.load(os.path.join(tmp,
                                                 f"zoo_logits_{arch}.pt"))
                   for arch, _, _ in TP_ZOO}
        for arch, depth, argv in TP_ZOO:
            want, o = one[arch]["logits"], outs[0][arch]
            g, g32 = got[arch]["bf16"], got[arch]["f32"]
            rel, rel32 = _rel(g, want), _rel(g32, one[arch]["f32"])
            spread = one[arch]["spread"]
            same_tok = int((g.argmax(-1) == want.argmax(-1)).sum())
            log(f"[tp-zoo] (a) {arch}"
                + (f" depth {depth}" if depth else " full depth")
                + f", full width, bf16, launch/serve.py {' '.join(argv)} "
                f"--mesh 1x2: prefill {o['prefill_s']:.2f} s (one card "
                f"{one[arch]['prefill_s']:.2f} s), decode {o['tok_s']:.2f} "
                f"tok/s (one card {one[arch]['tok_s']:.2f}); prefill logits "
                f"against the single card: float32 activations rel-L2 "
                f"{rel32:.3e} (gate {TP_ZOO_F32_TOL}), bf16 {rel:.3e} (gate "
                f"{TP_ZOO_SPREAD_X} x bf16's own spread, one card's bf16 "
                f"against its float32 activations: {spread:.3e}), greedy "
                f"token equal in {same_tok} of {want.shape[0]} rows")
            if rel32 > TP_ZOO_F32_TOL or not torch.isfinite(g32).all():
                failed.append(f"{arch}: float32 prefill logits rel-L2 "
                              f"{rel32}")
            if rel > TP_ZOO_SPREAD_X * spread or not torch.isfinite(g).all():
                failed.append(f"{arch}: bf16 prefill logits rel-L2 {rel} "
                              f"(bf16's spread {spread})")
            for r, o in enumerate(outs):
                o = o[arch]
                add(o["launches"])
                log(f"[tp-zoo] (a) {arch} rank {r}: the launcher's launches "
                    + json.dumps(o["launches"]))
                need = "wkv_scan_fwd" if arch == RWKV_ARCH \
                    else "flash_attention"
                if o["launches"][need] <= 0:
                    raise AssertionError(f"phase 17 (a) {arch} rank {r}: "
                                         f"{need} not launched")
                if arch not in TP_ZOO_QUORUM:
                    continue
                add(o["quorum_launches"])
                log(f"[tp-zoo] (b) {arch} depth {TP_ZOO_QUORUM[arch]} rank "
                    f"{r}: {N_REPLICAS} replicas, "
                    f"{TP_ZOO_REQUESTS} requests of {o['prompt_lens']} "
                    f"prompt tokens x {TP_ZOO_NEW} new: "
                    f"{o['quorum_s']:.2f} s ({o['quorum_tok_s']:.2f} tok/s),"
                    f" {o['quorum_gb']:.1f} GB a rank, ejections "
                    f"{o['ejections']}; the quorum run's launches "
                    + json.dumps(o["quorum_launches"]))
                if o["quorum"] != o["honest"] or \
                        o["quorum"] != outs[0][arch]["quorum"]:
                    raise AssertionError(f"phase 17 (b) {arch} rank {r}: the "
                                         "quorum run differs from the honest "
                                         "replica")
                if [i for _, i in o["ejections"]] != [N_REPLICAS - 1]:
                    raise AssertionError(f"phase 17 (b) {arch} rank {r}: "
                                         f"ejections {o['ejections']}")
                q = o["quorum_launches"]
                if q["cwise_median"] <= 0 or (
                        arch != RWKV_ARCH and q["flash_attention"] <= 0):
                    raise AssertionError(f"phase 17 (b) {arch} rank {r}: the "
                                         "median or the flash forward not "
                                         f"launched: {q}")
        if failed:   # every model's line printed first
            raise AssertionError("phase 17 (a): " + "; ".join(failed))
        log(f"[tp-zoo] (a) and (b): {time.perf_counter() - t0:.1f} s")

    # (c) and (d), run on phase 16 (b)'s ranks -------------------------------
    ranks_s = 0.0
    if TP_ZOO_RANKS:
        z = TP_ZOO_RANKS
        outs, steps = z["outs"], z["steps"]
        tp_want = model_volume_bytes(z["cfg"], 2, z["tokens"])
        for r, o in enumerate(o["zoo_train"] for o in outs):
            add(o["launches"])
            exact = collective_volume_bytes(z["pcfg"], o["P_m"])
            scatter = [b.get("pull", 0) + b.get("aggregate", 0)
                       for b in o["sent"]]
            warm = o["step_s"][1:] or o["step_s"]
            log(f"[tp-zoo] (c) {HYBRID_ARCH} {' '.join(z['argv'])} rank {r} "
                f"of 8 (mesh {o['mesh']}, P = {o['P']:,}, P_m = "
                f"{o['P_m']:,}): peak device memory {o['peak_gb']:.1f} GB; "
                f"{len(warm) / sum(warm):.4f} steps/s after the first (steps "
                f"{[round(x, 2) for x in o['step_s']]} s); bytes a step by "
                f"tag {o['sent']}; pull + aggregate {scatter} against "
                f"collective_volume_bytes(n_params=P_m) {exact}; the 'model' "
                f"tags' formula {tp_want}; launches "
                + json.dumps(o["launches"]))
            if o["mesh"] != {"rep": 4, "fsdp": 1, "model": 2} or any(
                    b != exact for b in scatter):
                raise AssertionError(f"phase 17 (c) rank {r}: mesh "
                                     f"{o['mesh']}, bytes {scatter} against "
                                     f"{exact}")
            for sent in o["sent"]:
                for tag, n in tp_want.items():
                    if sent.get(tag) != n:
                        raise AssertionError(f"phase 17 (c) rank {r}: {tag} "
                                             f"{sent.get(tag)} against {n}")
            for k in MESH_KERNELS:
                if o["launches"][k] < steps:
                    raise AssertionError(
                        f"phase 17 (c) rank {r}: {k} launched "
                        f"{o['launches'][k]} times in {steps} steps")
        losses = [x for _, x in outs[0]["zoo_train"]["losses"]]
        log(f"[tp-zoo] (c) losses (rank 0) {losses}")
        if len(losses) != steps or not np.all(np.isfinite(losses)):
            raise AssertionError(f"phase 17 (c): losses {losses}")
        ranks_s = max(o["zoo_train"]["part_s"] for o in outs)
        for arch in TP_ZOO_TINY:
            key = f"tiny_{arch}"
            run = _tiny_protocol("lm/tfm_tiny", arch, param_dtype="float32")
            cpu, sels, wall = _tiny_cpu(run)
            picked = [torch.tensor(p) for p in outs[0][key]["selections"]]
            for r, o in enumerate(o[key] for o in outs):
                add(o["launches"])
                if o["mesh"] != {"rep": 4, "fsdp": 1, "model": 2} or any(
                        not torch.equal(torch.tensor(p), q)
                        for p, q in zip(o["selections"], picked)):
                    raise AssertionError(f"phase 17 (d) {arch} rank {r}: "
                                         f"mesh {o['mesh']}, or its "
                                         "selections differ from rank 0's")
            o = outs[0][key]
            log(f"[tp-zoo] (d) {arch} reduced f32 on 8 ranks (mesh "
                f"{o['mesh']}) {o['wall']:.1f} s, on the CPU {wall:.1f} s; "
                f"launches a rank " + json.dumps(o["launches"]))
            _tiny_compare(run, {"cpu": cpu, "ranks": z["tiny"][arch]},
                          {"cpu": sels, "ranks": picked}, "tp-zoo",
                          "ranks")
            ranks_s += max(o[key]["part_s"] for o in outs)
    total["seconds"] = time.perf_counter() - t0 + ranks_s
    log(f"[tp-zoo] phase 17: {total['seconds']:.1f} s ({ranks_s:.1f} s of "
        f"it (c) and (d) on phase 16 (b)'s ranks)")
    return total


# ---------------------------------------------------------------------------
# phase 18: the dry run held against the card
# ---------------------------------------------------------------------------

DRY_MEM_TOL = 0.15      # the dry run's peak against the card's, relative
# (b): phi4-mini-3.8b's prefill of 4 x 1024 tokens at full width and depth
DRY_PREFILL = ("phi4-mini-3.8b", 1024, 4)
# (c): phase 16 (b)'s 8 ranks, left by tp_phase
TP_TRAIN_RANKS: dict = {}


def _card_measure(dev, fn, args) -> tuple[dict, float]:
    """The dry run's measurement (``dryrun.measure``) of ``fn(*args)`` on
    the card, and the step's peak: ``max_memory_allocated`` over the call
    (reset just before it), less what else was resident beside its
    arguments."""
    from repro_torch.launch import dryrun
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    fig, out = dryrun.measure(fn, args)
    torch.cuda.synchronize(dev)
    del out
    peak = torch.cuda.max_memory_allocated(dev)
    other = before - fig["memory"]["argument_bytes"]
    fig["card"] = dict(max_allocated=peak, resident_before=before,
                       other=other, peak=peak - other)
    return fig, peak - other


def _roofline_s(fig) -> tuple[float, str]:
    """One card's roofline estimate of a measured call: the larger of its
    FLOPs at the bf16 peak and its bytes at HBM's rate (reckoned, H100 SXM
    published peaks)."""
    from repro_torch.launch import roofline
    terms = {"compute": fig["flops"] / roofline.PEAK_FLOPS,
             "memory": fig["bytes_accessed"] / roofline.HBM_BW}
    dom = max(terms, key=terms.get)
    return terms[dom], dom


def _dry_gate(label: str, meta: dict, card: dict, card_peak: float) -> None:
    """FLOPs equal and the dry run's peak within ``DRY_MEM_TOL`` of the
    card's; the kernels' counts printed side by side."""
    mp = meta["memory"]["peak_bytes"]
    rel = abs(mp - card_peak) / card_peak
    log(f"[dry] {label}: FLOPs meta {meta['flops']:.6e}, card "
        f"{card['flops']:.6e} (equal: {meta['flops'] == card['flops']}); "
        f"bytes meta {meta['bytes_accessed']:.6e}, card "
        f"{card['bytes_accessed']:.6e}; aten ops {meta['aten_ops']} / "
        f"{card['aten_ops']}; peak meta {mp / 1e9:.3f} GB, card "
        f"{card_peak / 1e9:.3f} GB (max_memory_allocated "
        f"{card['card']['max_allocated'] / 1e9:.3f} GB less "
        f"{card['card']['other'] / 1e9:.3f} GB resident beside the "
        f"arguments): {100 * rel:.1f} % apart (gate "
        f"{100 * DRY_MEM_TOL:.0f} %); the meta run took {meta['wall_s']:.1f}"
        f" s on the host; kernels meta " + json.dumps(meta["kernels"])
        + " card " + json.dumps(card["kernels"]))
    if meta["flops"] != card["flops"] or meta["kernels"] != card["kernels"]:
        raise AssertionError(f"phase 18 {label}: the dry run's FLOPs "
                             f"{meta['flops']} against the card's "
                             f"{card['flops']}")
    if rel > DRY_MEM_TOL:
        raise AssertionError(f"phase 18 {label}: the dry run's peak "
                             f"{mp} B against the card's {card_peak} B")


def dry_protocol_phase(dev, state) -> None:
    """18 (a): phase 10's protocol step (phi4-mini-3.8b, depth 2, G = 4,
    ALIE x1, 4 x 1024 tokens a group) measured by the dry run on meta and
    on the card (phase 10's state, a scatter step of a fresh step function
    on each), then timed once more without the counter beside the
    roofline's estimate."""
    from repro_torch.core import protocol
    from repro_torch.core.attacks import ByzantineSpec
    from repro_torch.data.pipeline import token_stream
    from repro_torch.launch import dryrun, train
    from repro_torch.models.registry import get_bundle
    from repro_torch.optim.schedules import inverse_linear
    args = train.parser().parse_args(PROTO_ARGV)
    bundle = get_bundle(args.arch, reduced=args.reduced, depth=args.depth)
    byz = ByzantineSpec(worker_attack=args.worker_attack,
                        n_byz_workers=args.n_byz)
    pcfg = train.protocol_config(args.groups, args.T, args.engine, byz)
    lr = inverse_linear(args.lr, 0.005)

    def make():
        return protocol.make_scatter_step(bundle, pcfg, lr, with_attack=True)

    batch = next(token_stream(SEED + 2, bundle.cfg.vocab, args.groups,
                              args.batch_per_group, args.seq, 1,
                              device=dev))
    meta_state = protocol.make_init_fn(bundle, pcfg, "meta")(0)
    meta, _ = dryrun.measure(make(), (meta_state, {
        k: torch.empty_like(v, device="meta") for k, v in batch.items()}))
    step = make()
    card, card_peak = _card_measure(dev, step, (state, batch))
    _dry_gate("(a) phase 10's protocol step", meta, card, card_peak)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state = step(state, batch)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    est, dom = _roofline_s(meta)
    log(f"[dry] (a) the step on the card, without the counter: {wall:.3f} s;"
        f" the roofline's estimate (reckoned from the dry run, H100 SXM "
        f"published peaks, {dom}-bound) {est:.4f} s: measured / estimate "
        f"{wall / est:.2f}")


def dry_prefill_phase(dev) -> None:
    """18 (b): ``build_prefill_cell`` of ``DRY_PREFILL`` on a 1-rank mesh,
    on meta and on the card (random bf16 weights, zero tokens), held to
    (a)'s gates."""
    from repro_torch.configs.shapes import ShapeCell
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch import mesh as tmesh
    from repro_torch.models.registry import get_bundle
    arch, S, B = DRY_PREFILL
    cell = ShapeCell("card_prefill", "prefill", S, B)
    axes = ("data", "model")
    mcell = steps.build_prefill_cell(arch, cell, tmesh.RankView(axes, (1, 1)))
    with torch.no_grad():
        meta, _ = dryrun.measure(mcell.fn, mcell.in_specs)
        params = get_bundle(arch).init(
            torch.Generator(device=dev).manual_seed(SEED),
            dtype=torch.bfloat16)
        ccell = steps.build_prefill_cell(arch, cell,
                                         tmesh.Mesh(axes, (1, 1)),
                                         device=dev, params=params)
        del params
        card, card_peak = _card_measure(dev, ccell.fn, ccell.in_specs)
    _dry_gate(f"(b) build_prefill_cell({arch}, {B} x {S}) on a 1-rank mesh",
              meta, card, card_peak)
    del ccell
    gc.collect()
    torch.cuda.empty_cache()


def dry_ranks_phase() -> None:
    """18 (c): phase 16 (b)'s 8 ranks of the (4, 1, 2) mesh dry-run at its
    reckoned depth and tokens: each rank's bytes by tag equal to its
    ``Mesh.sent`` of the run's first step; the dry run's peak of the step
    beside the rank's measured peak (its whole run, the model's draw
    included)."""
    run = TP_TRAIN_RANKS
    if not run:
        log("[dry] (c) phase 16 (b) did not run: nothing to hold")
        return
    for r, o in enumerate(run["outs"]):
        fig = _rank_peak(run["cfg"], run["pcfg"], run["batch"], rank=r)
        want = {k: v for k, v in o["train"]["sent"][0].items() if v}
        got = {k: int(v) for k, v in fig["collective_bytes_by_kind"].items()}
        log(f"[dry] (c) rank {r} of the (4, 1, 2) mesh: bytes by tag, dry "
            f"run {got}, Mesh.sent {want} (equal: {got == want}); the dry "
            f"run's step peak {fig['memory']['peak_bytes'] / 1e9:.2f} GB, the "
            f"rank's measured peak {o['train']['peak_gb']:.2f} GB")
        if got != want:
            raise AssertionError(f"phase 18 (c) rank {r}: {got} against "
                                 f"{want}")


def dry_cell_phase() -> None:
    """18 (d): phi4-mini-3.8b x train_4k on the 16 x 16 production mesh,
    dry-run for its fullest rank (the DMC gather too), as a roofline row
    with the host's wall time."""
    from repro_torch.launch import dryrun, roofline
    t0 = time.perf_counter()
    res = dryrun.run_cell("phi4-mini-3.8b", "train_4k", multi_pod=False,
                          engine="naive", include_gather=True)
    wall = time.perf_counter() - t0
    row = roofline.row_of(res, "phi4-mini-3.8b", "train_4k")
    log(f"[dry] (d) phi4-mini-3.8b x train_4k on 16x16 (rank {res['rank']}, "
        f"G = {res['n_groups']}, mesh {res['byz_mesh']}), dry run {wall:.1f} "
        f"s on this host ({res['full']['aten_ops']} aten ops); roofline row "
        f"(reckoned from the dry run, H100 SXM published peaks): compute "
        f"{row['t_compute_s']:.4f} s, memory {row['t_memory_s']:.4f} s, "
        f"collective {row['t_collective_s']:.4f} s, {row['dominant']}-bound,"
        f" estimate {row['est_step_s']:.4f} s a step, MFU "
        f"{100 * row['roofline_fraction']:.1f} %, useful FLOPs "
        f"{row['useful_flops_ratio']:.2f}, {row['mem_per_dev_gib']:.2f} GiB a"
        f" rank (fits 80 GB: {row['fits']})")


def analyze_card_phase(dev) -> float:
    """Phase 19: layer 3 of ``repro_torch.analyze`` on the card. Prints
    each engine's device->host copies per ``run()``, its syncs per step and
    whether ``run_epoch`` passes sync-debug "error", serving's syncs per
    decode step and per token, and each finding with its baseline status;
    raises on a finding the baseline does not hold. Returns its seconds."""
    from repro_torch.analyze import card
    from repro_torch.analyze import findings as F
    t0 = time.perf_counter()
    stats = card.measure(dev)
    for label, s in stats.items():
        sites = ", ".join(f"{k} x{v}" for k, v in sorted(s["sync_sites"]
                                                          .items()))
        if label == "serve":
            log(f"[analyze-card] serve decode: "
                f"{s['syncs_per_decode_step']} syncs a step, "
                f"{s['syncs_per_token']:.2f} per token; at {sites or '-'}")
            continue
        log(f"[analyze-card] {label}: {s['dtoh_per_run']} device->host "
            f"copies per run(); {s['syncs_per_step']:.2f} syncs per step "
            f"(at {sites or '-'}); run_epoch under sync-debug 'error': "
            f"{'passes' if s['epoch_error'] is None else 'raises'}")
    base = F.load_baseline(str(ROOT / F.BASELINE_PATH))
    new, known = F.split_baselined(card.findings(stats), base)
    for f in known:
        log(f"[analyze-card] baselined: {f.path}: {f.message}")
    if new:
        raise AssertionError("analyze --card: findings neither baselined "
                             "nor suppressed:\n"
                             + "\n".join(f.format() for f in new))
    dt = time.perf_counter() - t0
    log(f"[analyze-card] phase 19 took {dt:.1f} s")
    return dt


def dry_phase(dev) -> float:
    """Phase 18 (b)-(d) ((a) runs on phase 10's state, after phase 12
    (a)); returns its seconds."""
    t0 = time.perf_counter()
    dry_prefill_phase(dev)
    dry_ranks_phase()
    dry_cell_phase()
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phase 20: elastic membership over ranks sharing the card
# ---------------------------------------------------------------------------

ELASTIC_RANKS = 8       # the reference lane's world
# the reference's (rep, fsdp, 1) for G = 5, 4, 5 on 8 ranks: ranks 5-7 sit
# the G = 5 segments out, and 'fsdp' grows to 2 at G' = 4
ELASTIC_MESHES = [(5, 1, 1), (4, 2, 1), (5, 1, 1)]
# the whole final params against phase 12 (c)'s one-rank card run (rel-L2,
# rel-max): the Gram's partials and the aggregation's sum over senders add
# in rank order over the ranks, in the kernels' and cuBLAS's order on one
# card
ELASTIC_TOL = (1e-4, 1e-3)
ELASTIC_KERNELS = ("cwise_median", "gram", "subset_diameters")


def _sent_by_tag() -> dict:
    """Bytes this rank has sent on every segment mesh of the world, by
    tag."""
    from repro_torch.exp import runners
    out: dict = {}
    for _, m in runners._MESH_CACHE.values():
        for k, v in m.sent.items():
            out[k] = out.get(k, 0) + v
    return out


@contextlib.contextmanager
def _elastic_hooks(rank: int):
    """Phase 20's records of one run on one rank: each segment's mesh and
    whether the rank holds a block of it, the bytes by tag at each
    boundary's start and end (and the run's), and each boundary's
    ``reform`` bytes beside ``reform_volume_bytes``."""
    from repro_torch.core import membership
    from repro_torch.exp import runners
    rec = {"segments": [], "marks": [_sent_by_tag()], "boundaries": []}
    seg_mesh, reform = runners._segment_mesh, membership.reform_state

    def segment_mesh(G):
        mesh = seg_mesh(G)
        rec["segments"].append([list(mesh.shape), mesh.member])
        return mesh

    def reform_state(state, old_active, new_active, mesh=None,
                     chunk_bytes=256 * 2**20):
        rec["marks"].append(_sent_by_tag())
        old = state.mesh
        sent = old.sent["reform"]
        out = reform(state, old_active, new_active, mesh, chunk_bytes)
        rec["boundaries"].append(dict(
            old=list(old.shape), new=list(mesh.shape),
            sent=old.sent["reform"] - sent,
            want=membership.reform_volume_bytes(
                old.shape, mesh.shape, len(old_active), state.tree.size,
                state.params.element_size(), rank=rank,
                stacks=3 if state.opt else 1,
                run_state_bytes=state.gen.get_state().numel() + 16)))
        rec["marks"].append(_sent_by_tag())
        return out

    runners._segment_mesh = segment_mesh
    membership.reform_state = reform_state
    try:
        yield rec
    finally:
        runners._segment_mesh = seg_mesh
        membership.reform_state = reform
        rec["marks"].append(_sent_by_tag())


def _elastic_rank(dev, rank: int, tmp: str) -> dict:
    """One rank of phase 20: ``elastic/planned_churn`` at ``mlp_h1024``
    uninterrupted, with ``ckpt_every=4``, and killed after step 12 (the
    saves past it deleted) and resumed; each run's launches counted from 0
    around it."""
    import torch.distributed as dist

    from repro_torch import exp
    from repro_torch.checkpoint import checkpointer as ck
    from repro_torch.core import protocol
    counters = _counters()
    out = {}

    def run(label, **kw):
        _zero_counts(counters)
        with _elastic_hooks(rank) as rec, _selections() as picked:
            t0 = time.perf_counter()
            res = exp.run("elastic/planned_churn", device=dev, **ELASTIC_RUN,
                          **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        whole = protocol.whole_state(res.state)
        rec.update(launches=_read_counts(counters), wall=wall,
                   final=res.final, logs=res.logs,
                   prov_mesh=res.provenance["mesh"],
                   epochs=res.provenance["membership"]["epochs"],
                   resumed_at=res.provenance["membership"]["resumed_at"],
                   block=list(res.state.params.shape), t=res.state.t,
                   gen=res.state.gen.get_state().tolist(),
                   P=res.state.tree.size, steps=len(picked),
                   fingerprint=fingerprint(whole.params))
        if rank == 0 and label == "whole":
            torch.save({"params": whole.params.cpu(), "selections": picked},
                       os.path.join(tmp, "elastic_whole.pt"))
        out[label] = rec

    run("whole")
    d = os.path.join(tmp, "elastic_ck")
    run("ckpt", ckpt_dir=d, ckpt_every=4)
    dist.barrier()
    if rank == 0:
        for name in os.listdir(d):
            if int(name.split("_")[-1]) > 12:
                shutil.rmtree(os.path.join(d, name))
        out["meta12"] = ck.read_manifest(d, 12).get("meta")
    dist.barrier()
    run("resumed", ckpt_dir=d, ckpt_every=4)
    return out


RANK_TASKS["elastic"] = _elastic_rank


def elastic_ranks_phase(dev, reference: dict) -> dict:
    """Phase 20: ``elastic/planned_churn`` at ``mlp_h1024`` on 8 ranks
    sharing the card over gloo (spawned), uninterrupted, with
    ``ckpt_every=4`` and killed after step 12 and resumed, against phase
    12 (c)'s one-rank card run of the same spec (``reference``). Returns
    the kernel launches of its runs, by key."""
    import tempfile

    from repro_torch import exp
    from repro_torch.core import membership
    from repro_torch.core.protocol import collective_volume_bytes
    t0 = time.perf_counter()
    R = ELASTIC_RANKS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_elastic_ranks_") \
            as tmp:
        outs = _spawn_ranks("elastic", R, tmp)
        mine = torch.load(os.path.join(tmp, "elastic_whole.pt"))
    pcfg0 = exp.get("elastic/planned_churn", **ELASTIC_RUN) \
        .to_protocol_config()
    total = {k: 0 for k in ELASTIC_KERNELS}
    base = outs[0]["whole"]
    P = base["P"]
    log(f"[elastic-ranks] elastic/planned_churn at {TRAIN_MODEL} (P = "
        f"{P:,}) on {R} ranks sharing the card over gloo: segment meshes "
        f"{[s for s, _ in base['segments']]}, epochs "
        f"{[(e['start'], len(e['active'])) for e in base['epochs']]}")
    for r, o in enumerate(outs):
        for label in ("whole", "ckpt", "resumed"):
            rec = o[label]
            for k in ELASTIC_KERNELS:
                total[k] += rec["launches"][k]
            # bytes inside each segment (between boundaries) and at each
            marks = rec["marks"]
            segs = [{k: b.get(k, 0) - a.get(k, 0) for k in b}
                    for a, b in zip(marks[::2], marks[1::2])]
            epochs = [e for e in rec["epochs"]
                      if e["stop"] > (rec["resumed_at"] or 0)]
            for i, (seg, (shape, member), e) in enumerate(zip(
                    segs, rec["segments"], epochs)):
                steps = e["stop"] - max(e["start"], rec["resumed_at"] or 0)
                if tuple(shape) != ELASTIC_MESHES[3 - len(epochs) + i] or \
                        member != (r < int(np.prod(shape))):
                    raise AssertionError(f"phase 20 rank {r} {label}: "
                                         f"segment {i} mesh {shape}")
                if not member:
                    if any(seg.values()):
                        raise AssertionError(f"phase 20 rank {r} {label}: "
                                             f"idle in segment {i}, sent "
                                             f"{seg}")
                    if label == "whole":
                        log(f"[elastic-ranks] rank {r} segment {i} (mesh "
                            f"{shape}): idle, 0 bytes sent")
                    continue
                K = shape[1]
                k = r % K
                cols = (k + 1) * P // K - k * P // K
                pcfg = membership.epoch_config(pcfg0, tuple(e["active"]))
                want = steps * collective_volume_bytes(pcfg, cols,
                                                       rep=shape[0])
                got = seg.get("pull", 0) + seg.get("aggregate", 0)
                if got != want:
                    raise AssertionError(f"phase 20 rank {r} {label}: "
                                         f"segment {i} pull + aggregate "
                                         f"{got} against {want}")
                if label == "whole":
                    log(f"[elastic-ranks] rank {r} segment {i} (mesh "
                        f"{shape}, {steps} steps): bytes by tag "
                        f"{dict(sorted(seg.items()))}; pull + aggregate "
                        f"{got} = {steps} x collective_volume_bytes "
                        f"{want // steps}")
            for b in rec["boundaries"]:
                if b["sent"] != b["want"]:
                    raise AssertionError(f"phase 20 rank {r} {label}: "
                                         f"reform {b['sent']} bytes against "
                                         f"reform_volume_bytes {b['want']}")
            if label == "whole":
                log(f"[elastic-ranks] rank {r}: reform bytes at the "
                    f"boundaries {[b['sent'] for b in rec['boundaries']]} "
                    f"= reform_volume_bytes "
                    f"{[b['want'] for b in rec['boundaries']]}; launches "
                    + json.dumps({k: rec["launches"][k]
                                  for k in ELASTIC_KERNELS})
                    + f" over its {rec['steps']} steps; peak device memory "
                    f"{o['peak_gb']:.3f} GB (its three runs)")
            # every rank that ran steps launched the kernels each step
            for k in ELASTIC_KERNELS:
                if rec["launches"][k] < rec["steps"]:
                    raise AssertionError(f"phase 20 rank {r} {label}: {k} "
                                         f"launched {rec['launches'][k]} "
                                         f"times in {rec['steps']} steps")
            for key in ("final", "prov_mesh", "t", "gen", "fingerprint"):
                if rec[key] != outs[0][label][key]:
                    raise AssertionError(f"phase 20 rank {r} {label}: "
                                         f"{key} differs from rank 0's")
    # the same world's runs: checkpoints and the resume change nothing
    whole, ckpt, resumed = (outs[0][k] for k in ("whole", "ckpt",
                                                 "resumed"))
    by_step = {m["step"]: m for m in whole["logs"]}
    same_ckpt = (ckpt["fingerprint"] == whole["fingerprint"]
                 and ckpt["final"] == whole["final"]
                 and ckpt["logs"] == whole["logs"])
    same_resumed = (resumed["fingerprint"] == whole["fingerprint"]
                    and resumed["final"] == whole["final"]
                    and resumed["resumed_at"] == 12
                    and resumed["logs"] and all(
                        m == by_step[m["step"]] for m in resumed["logs"]))
    meta = outs[0]["meta12"]
    log(f"[elastic-ranks] ckpt_every=4 bit-identical to the uninterrupted "
        f"run: {same_ckpt}; killed after step 12 (saved with active "
        f"{meta['active']}) and resumed at {resumed['resumed_at']}: "
        f"bit-identical {same_resumed}")
    if not (same_ckpt and same_resumed and meta["active"] == [0, 1, 2, 3]):
        raise AssertionError("phase 20: the checkpointed or resumed run "
                             "differs from the uninterrupted one")
    # against phase 12 (c)'s one-rank run of the same spec
    a, b = mine["params"].double(), reference["params"].double()
    rel_l2 = ((a - b).norm() / b.norm()).item()
    rel_max = ((a - b).abs().max() / b.abs().max()).item()
    same_sel = sum(torch.equal(x > 0, y > 0) for x, y in zip(
        mine["selections"], reference["selections"]))
    steps_s = 24 / whole["wall"]
    log(f"[elastic-ranks] against phase 12 (c)'s one-rank run: rel-L2 "
        f"{rel_l2:.3g}, rel-max {rel_max:.3g} (tolerance {ELASTIC_TOL}); "
        f"MDA selections equal at {same_sel} of "
        f"{len(reference['selections'])} steps; final acc "
        f"{whole['final']['acc']:.4f} against {reference['acc']:.4f}; "
        f"{steps_s:.3f} steps/s on {R} ranks ({whole['wall']:.2f} s, "
        f"gloo through the host on one card: not a link's rate) against "
        f"{reference['steps_s']:.2f} on one; peak device memory of the "
        f"{R} ranks together {sum(o['peak_gb'] for o in outs):.2f} GB")
    if rel_l2 > ELASTIC_TOL[0] or rel_max > ELASTIC_TOL[1] \
            or not np.isfinite(whole["final"]["acc"]):
        raise AssertionError(f"phase 20: rel-L2 {rel_l2}, rel-max "
                             f"{rel_max} against the one-rank run")
    log(f"[elastic-ranks] phase 20 took {time.perf_counter() - t0:.1f} s")
    return total


# ---------------------------------------------------------------------------
# phase 21: the 'model' axis for the paper's MLPs over ranks sharing the card
# ---------------------------------------------------------------------------

MLP_MODEL_RANKS = 4
MLP_MODEL_MESH = {"rep": 2, "fsdp": 1, "model": 2}
MLP_MODEL_STEPS = 12
# the whole final params against the one-card run (rel-L2): the row-parallel
# products sum two partials and the Gram its ranks' partials in rank order,
# where one card sums in cuBLAS's and the kernel's order
MLP_MODEL_TOL = 1e-4
# a step's MDA selections are held equal where, for every server, the
# one-card run's best subset diameter is clear of the runner-up by more
# than this share of the quorum's largest squared distance (the Gram's
# float32 noise between two summation orders is ~1e-6 of it)
MLP_MODEL_TIE = 1e-4


def _mlp_model_spec():
    """Phase 21's run: ``quickstart`` at ``mlp_h1024`` on its
    ``mixture10_easy``, G = 4 groups (f_w = 1, f_ps = 0, ALIE on one
    worker), T = 5, 12 protocol steps on numpy quorum tables and batches:
    (experiment, protocol config, tables, (x, y))."""
    from repro_torch.core.attacks import ByzantineSpec
    from repro_torch.exp import presets
    e = presets.get("quickstart", model=TRAIN_MODEL, n_workers=4,
                    f_workers=1, n_servers=4, f_servers=0, T=5,
                    steps=MLP_MODEL_STEPS, byz=ByzantineSpec(
                        worker_attack="alie", n_byz_workers=1))
    pcfg = e.to_protocol_config()
    rng = np.random.default_rng(SEED + 21)
    tables = _token_tables(rng, pcfg.n_groups, pcfg.q_workers,
                           pcfg.q_servers, pcfg.T, MLP_MODEL_STEPS)
    x, y = _mixture_batches(rng, MLP_MODEL_STEPS, pcfg.n_groups, e.batch,
                            e.mixture)
    return e, pcfg, tables, (x, y)


@contextlib.contextmanager
def _mda_inputs():
    """Every step's ``(d2, quorum indices, weights)`` of the MDA rule in
    the protocol runs inside the block (kept on the device until the block
    ends)."""
    from repro_torch.core import protocol
    qw, rec = protocol.quorum_weights, []

    def record(d2, idx, f, cfg):
        w = qw(d2, idx, f, cfg)
        rec.append((d2.clone(), idx.clone(), w.clone()))
        return w

    protocol.quorum_weights = record
    try:
        yield rec
    finally:
        protocol.quorum_weights = qw
        rec[:] = [tuple(t.cpu() for t in r) for r in rec]


def _mlp_model_steps(dev, mesh=None):
    """Phase 21's run on ``dev`` (on ``mesh``'s ranks), a step at a time:
    (final state, each step's ``(d2, quorum, weights)``, each step's bytes
    sent by tag, the wall seconds of the 12 steps)."""
    from repro_torch.core import protocol
    from repro_torch.core.quorum import TraceDelivery
    e, pcfg, tables, (x, y) = _mlp_model_spec()
    eng = protocol.ProtocolEngine(
        e.build_bundle(), pcfg, e.build_schedule(), with_attack=True,
        delivery=TraceDelivery(*tables, T=pcfg.T, device=dev), device=dev,
        mesh=mesh)
    state = eng.init_state(SEED)
    x, y = x.to(dev), y.to(dev)
    sent = []
    with _mda_inputs() as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(MLP_MODEL_STEPS):
            before = dict(mesh.sent) if mesh is not None else {}
            state, _ = eng.run(state, (x[i:i + 1], y[i:i + 1]))
            if mesh is not None:
                sent.append({k: v - before.get(k, 0)
                             for k, v in mesh.sent.items()})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return state, rec, sent, wall


def _mlp_model_rank(dev, rank: int, tmp: str) -> dict:
    """One rank of phase 21 on the (rep 2, fsdp 1, model 2) mesh."""
    from repro_torch.core import protocol
    from repro_torch.launch import mesh as tmesh
    mesh = tmesh.make_protocol_mesh(4, model=2)
    state, rec, sent, wall = _mlp_model_steps(dev, mesh)
    whole = protocol.whole_state(state).params
    if rank == 0:
        torch.save({"params": whole.cpu(), "weights": [w for *_, w in rec]},
                   os.path.join(tmp, "mlp_model.pt"))
    ranks = protocol._Ranks(mesh, 4, state.tree.size,
                            protocol.ProtocolConfig.chunk_bytes, state.split)
    return dict(mesh=mesh.sizes, backend=mesh.backend, sent=sent, wall=wall,
                P=state.tree.size, P_m=state.split.local.size,
                dims=state.split.dims, cols=ranks.k1 - ranks.k0,
                steps=len(rec), fingerprint=fingerprint(whole))


RANK_TASKS["mlp_model"] = _mlp_model_rank


def _tied_steps(rec, f: int) -> list[bool]:
    """For each step of a run's ``(d2, quorum, weights)``: whether some
    server's best subset diameter (over its quorum's subsets of q - f) is
    within ``MLP_MODEL_TIE`` of its quorum's largest squared distance of
    the runner-up."""
    import itertools
    out = []
    for d2, idx, _ in rec:
        d2 = d2.double()
        tied = False
        for row in idx.tolist():
            diams = sorted(max((d2[a, b].item() for a, b in
                                itertools.combinations(sub, 2)), default=0.0)
                           for sub in itertools.combinations(
                               row, len(row) - f))
            scale = max(d2[a, b].item() for a in row for b in row)
            if len(diams) > 1 and diams[1] - diams[0] <= MLP_MODEL_TIE * scale:
                tied = True
        out.append(tied)
    return out


def mlp_model_phase(dev) -> dict:
    """Phase 21: ``quickstart``'s MLP at ``mlp_h1024`` through the protocol
    engine on 4 ranks sharing the card over gloo at (rep 2, fsdp 1, model
    2), held against the same spec on one card (in this process, first).
    Returns the kernel launches of the ranks' run, by key."""
    import tempfile

    from repro_torch.core import protocol
    from repro_torch.core.simulator import FlatTree
    t0 = time.perf_counter()
    e, pcfg, _, _ = _mlp_model_spec()
    bundle = e.build_bundle()
    tree = FlatTree.from_params(bundle.meta_params())
    state, ref, _, ref_wall = _mlp_model_steps(dev)
    ref_params = state.params.cpu()
    del state
    tied = _tied_steps(ref, pcfg.f_workers)
    rows = e.batch                         # a group's rows: fsdp = 1
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mlp_model_") as tmp:
        outs = _spawn_ranks("mlp_model", MLP_MODEL_RANKS, tmp)
        mine = torch.load(os.path.join(tmp, "mlp_model.pt"))
    dims = outs[0]["dims"]
    tp = protocol.model_volume_bytes(bundle.cfg, 2, rows, n_groups=2,
                                     tree=tree)
    log(f"[mlp-model] quickstart at {TRAIN_MODEL} (P = {outs[0]['P']:,}, "
        f"G = 4, ALIE x1, T = 5, {MLP_MODEL_STEPS} steps) on "
        f"{MLP_MODEL_RANKS} ranks sharing the card over "
        f"{outs[0]['backend']}, mesh {outs[0]['mesh']}: the leaves' 'model' "
        f"dims {dict(zip(('/'.join(p) for p in tree.paths), dims))}, P_m = "
        f"{outs[0]['P_m']:,} a rank; model_volume_bytes {tp} a step")
    total = {k: 0 for k in ELASTIC_KERNELS}
    for r, o in enumerate(outs):
        if o["mesh"] != MLP_MODEL_MESH:
            raise AssertionError(f"phase 21 rank {r}: mesh {o['mesh']}")
        want = protocol.collective_volume_bytes(pcfg, o["cols"], rep=2)
        for i, sent in enumerate(o["sent"]):
            got = sent.get("pull", 0) + sent.get("aggregate", 0)
            if got != want or any(sent.get(k, 0) != n for k, n in tp.items()) \
                    or "model_leaves" in sent:
                raise AssertionError(
                    f"phase 21 rank {r} step {i}: bytes by tag {sent}; "
                    f"collective_volume_bytes {want}, model_volume_bytes "
                    f"{tp}")
        for k in ELASTIC_KERNELS:
            total[k] += o["launches"][k]
            if o["launches"][k] < o["steps"]:
                raise AssertionError(f"phase 21 rank {r}: {k} launched "
                                     f"{o['launches'][k]} times in "
                                     f"{o['steps']} steps")
        if o["fingerprint"] != outs[0]["fingerprint"]:
            raise AssertionError(f"phase 21 rank {r}: whole params differ "
                                 "from rank 0's")
        log(f"[mlp-model] rank {r}: bytes by tag, step 1 "
            f"{dict(sorted(o['sent'][0].items()))}, step 5 (a DMC gather) "
            f"{dict(sorted(o['sent'][4].items()))}; pull + aggregate {want} "
            f"= collective_volume_bytes on its {o['cols']:,} columns, every "
            f"step; launches " + json.dumps({k: o["launches"][k]
                                            for k in ELASTIC_KERNELS})
            + f" in {o['steps']} steps; peak device memory "
            f"{o['peak_gb']:.3f} GB")
    a, b = mine["params"].double(), ref_params.double()
    rel_l2 = ((a - b).norm() / b.norm()).item()
    rel_max = ((a - b).abs().max() / b.abs().max()).item()
    same = [torch.equal(w > 0, ref_w.cpu() > 0)
            for w, (*_, ref_w) in zip(mine["weights"], ref)]
    clear = [i for i, t in enumerate(tied) if not t]
    wall = outs[0]["wall"]
    log(f"[mlp-model] against the one-card run: rel-L2 {rel_l2:.3g} "
        f"(gate {MLP_MODEL_TOL}), rel-max {rel_max:.3g}; MDA selections "
        f"equal at {sum(same)} of {len(ref)} steps, {len(clear)} of them "
        f"clear of a tie (the best diameter more than {MLP_MODEL_TIE} of "
        f"the quorum's largest squared distance from the runner-up) and "
        f"held equal; {MLP_MODEL_STEPS / wall:.3f} steps/s on "
        f"{MLP_MODEL_RANKS} ranks ({wall:.2f} s, gloo through the host on "
        f"one card: not a link's rate) against {MLP_MODEL_STEPS / ref_wall:.3f}"
        f" on one card ({ref_wall:.2f} s)")
    if len(same) != len(ref) or not all(same[i] for i in clear) \
            or not rel_l2 < MLP_MODEL_TOL or not torch.isfinite(a).all():
        raise AssertionError(f"phase 21: rel-L2 {rel_l2}, selections equal "
                             f"{same}, tied {tied}")
    log(f"[mlp-model] phase 21 took {time.perf_counter() - t0:.1f} s")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import device as devmod
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = devmod.resolve("cuda")
    card = card_line()
    log(f"[card] {card} | torch {torch.__version__} (CUDA "
        f"{torch.version.cuda}) | ninja: {shutil.which('ninja') or 'absent'}")
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"[build] {len(reports)} kernel libraries built in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, text in reports.items():
        for fn, usage in _build.ptxas_usage(text).items():
            log(f"[build] {name}: {fn}: {ptxas_text(usage)}")
            PTXAS[fn] = usage
        for line in text.splitlines():
            if re.search(r"\(C\d+\)", line):   # ptxas advice, e.g. C7519
                log(f"[build] {name}: {line.strip()[:300]}")
    meamed_build_check(_build)
    # phase 19 first: its profiler counts precede any CUDA graph, and its
    # engines need autograd (outside inference mode)
    analyze_card_phase(dev)

    with torch.inference_mode():
        select_launch_phase(dev)
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
    train_launches, train_results = train_phase(dev)
    launches["cwise_median"] += train_launches["cwise_median"]
    launches.update({k: v for k, v in train_launches.items()
                     if k != "cwise_median"})
    bwd_rows = flash_bwd_phase(dev)
    protocol_reference_phase(dev)
    proto_launches, proto_rows, proto, state = protocol_train_phase(dev)
    for k, v in proto_launches.items():
        launches[k] = launches.get(k, 0) + v
    # phase 12 (a) on phase 10's state, before phase 11 takes the card
    ckpt_launches, _ = checkpoint_phase(dev, state)
    # phase 18 (a) on the same state
    t18 = time.perf_counter()
    dry_protocol_phase(dev, state)
    t18 = time.perf_counter() - t18
    del state
    gc.collect()
    torch.cuda.empty_cache()
    netsim_reference_phase(dev)
    netsim_launches, _ = netsim_train_phase(dev, train_results["busy"])
    resume_launches = resume_phase(dev)
    elastic_launches, elastic_ref = elastic_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    # phase 13: the zoo. (a) the flash forward at qwen3-moe's heads
    flash.append(flash_row(dev, 1, 1024, 64, 4, 64, 0, tag="zoo-kernel",
                           main=False))
    wkv_rows = wkv_scan_phase(dev)
    zoo_launches = []
    for zs in ZOO_SERVE[:1]:                                    # (b)
        zoo_launches.append(zoo_serve_phase(dev, *zs)[0])
        gc.collect()
        torch.cuda.empty_cache()
    zoo_launches.append(zoo_train_phase(dev)[0])                # (c)
    for zs in ZOO_SERVE[1:]:                                    # (d)
        zoo_launches.append(zoo_serve_phase(dev, *zs)[0])
        gc.collect()
        torch.cuda.empty_cache()
    zoo_launches.append(zoo_reference_phase(dev))               # (e)
    gc.collect()
    torch.cuda.empty_cache()
    # phase 14: the rest of the zoo. (a) the flash kernels at its shapes
    fwd2, bwd2 = zoo2_kernel_phase(dev)
    flash += fwd2
    for k, rs in bwd2.items():
        bwd_rows[k] += rs
    for part in (vlm_serve_phase,                               # (b)
                 lambda d: zoo_serve_phase(d, *HYBRID_SERVE),   # (c)
                 hybrid_train_phase, audio_phase):              # (d), (e)
        zoo_launches.append(part(dev)[0])
        gc.collect()
        torch.cuda.empty_cache()
    zoo_launches.append(zoo2_reference_phase(dev))              # (f)
    gc.collect()
    torch.cuda.empty_cache()
    # phase 15: the protocol over torch.distributed ranks
    mesh_launches = mesh_phase(dev, proto.pop("reference"))
    gc.collect()
    torch.cuda.empty_cache()
    # phase 16: the 'model' axis over ranks
    t16 = time.perf_counter()
    tp_launches = tp_phase(dev)
    log(f"[tp] phase 16 took {time.perf_counter() - t16:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    # phase 17: the 'model' axis for the other families
    zoo_tp = tp_zoo_phase(dev)
    zoo_tp.pop("seconds")
    for k, v in zoo_tp.items():
        tp_launches[k] = tp_launches.get(k, 0) + v
    gc.collect()
    torch.cuda.empty_cache()
    # phase 18: the dry run held against the card
    t18 += dry_phase(dev)
    log(f"[dry] phase 18 took {t18:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    # phase 20: elastic membership over ranks
    elastic_rank_launches = elastic_ranks_phase(dev, elastic_ref)
    gc.collect()
    torch.cuda.empty_cache()
    # phase 21: the 'model' axis for the paper's MLPs over ranks
    mlp_model_launches = mlp_model_phase(dev)
    for part in (ckpt_launches, netsim_launches, resume_launches,
                 elastic_launches, *zoo_launches, mesh_launches,
                 tp_launches, elastic_rank_launches, mlp_model_launches):
        for k, v in part.items():
            launches[k] = launches.get(k, 0) + v

    rows = dict(train_rows)
    rows.update(bwd_rows)
    rows.update(wkv_rows)
    rows["flash_attention"] = flash
    rows["cwise_median"] = [dict(r, nbytes=4.0 * (r["n"] + 1) * N_SLOTS
                                 * 200064) for r in median] \
        + train_rows["cwise_median"] + proto_rows["cwise_median"]
    rows["gram"] = train_rows["gram"] + proto_rows["gram"]
    kernels = []
    for name, src, replaces in (
            ("flash_attention", "flash_attention/csrc/flash_fwd.cu",
             "kernels/flash_attention/kernel.py:28"),
            ("cwise_median", "cwise_median/csrc/cwise_median.cu",
             "kernels/cwise_median/kernel.py:54"),
            ("cwise_trimmed_mean", "cwise_median/csrc/cwise_median.cu",
             "kernels/cwise_median/kernel.py:60"),
            ("cwise_meamed", "cwise_median/csrc/cwise_median.cu",
             "kernels/cwise_median/kernel.py:69"),
            ("gram", "pairwise_sqdist/csrc/gram.cu",
             "kernels/pairwise_sqdist/kernel.py:24"),
            ("subset_diameters", "mda_diameter/csrc/mda_diameter.cu",
             "kernels/mda_diameter/kernel.py:17"),
            ("flash_bwd_dq", "flash_attention/csrc/flash_bwd.cu",
             "kernels/flash_attention/kernel.py:135"),
            ("flash_bwd_dkv", "flash_attention/csrc/flash_bwd.cu",
             "kernels/flash_attention/kernel.py:164"),
            # no TPU kernel: the reference's jax.lax.scan over the chunks
            ("wkv_scan_fwd", "wkv_scan/csrc/wkv_scan.cu",
             "models/rwkv6.py:125"),
            ("wkv_scan_bwd", "wkv_scan/csrc/wkv_scan.cu",
             "models/rwkv6.py:125")):
        rs = rows[name]
        on_path = [r for r in rs if r.get("main", True)]
        # the row of the path's largest call (flash forward and backward:
        # the protocol run's shape)
        main_row = (max(on_path, key=lambda r: (r["S"], -r["window"]))
                    if name == "flash_attention"
                    else max(on_path, key=lambda r: r["flops"])
                    if name.startswith("flash_bwd")
                    else max(on_path, key=lambda r: r["nbytes"]))
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{src}",
            "replaces": f"src/repro/{replaces}",
            "launches": launches[name],
            "mesh_launches": mesh_launches.get(name, 0),
            "tp_launches": tp_launches.get(name, 0),
            "elastic_launches": elastic_rank_launches.get(name, 0),
            "mlp_model_launches": mlp_model_launches.get(name, 0),
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"]})
    log(f"[smoke] chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Roofline of every dry-run cell on the H100 — the port of
``repro.launch.roofline``, reading ``launch/dryrun.py``'s artifacts
(``results/dryrun_torch/<mesh>/``).

Hardware model (one H100 SXM, NVIDIA's published dense peaks; PERF.md
§3): 989e12 FLOP/s bf16, 3.35e12 B/s HBM, and for collectives NVLink's
450e9 B/s each way. The dry run's figures are per rank, so:

    compute term    = flops / PEAK_FLOPS                       [s]
    memory term     = bytes_accessed / HBM_BW                  [s]
    collective term = bytes sent a rank / LINK_BW              [s]

Every row is reckoned from the dry run on those published peaks, not
measured. The collective term is a lower bound: a 16 x 16 mesh of 8-card
hosts crosses hosts on both axes, and the links between hosts are slower
than NVLink. ``flops`` counts the kernels' own operations (the median's
compare-exchanges too) and no elementwise work, so the compute term is
the tensor-core bound on the products and the attention.

MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) per step across the
whole job; MODEL_FLOPS / (flops * ranks) exposes remat, duplicated work
on 'model' ranks and protocol overhead. DMC gather terms are amortised by
1/T.
"""
from __future__ import annotations

import json
import os

from ..configs.shapes import SHAPES
from ..models.registry import ARCH_IDS, get_bundle

# one H100 SXM, dense, at its 700 W limit: bf16 tensor cores, HBM3
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
# NVLink 4 on the H100 SXM: 900 GB/s a card, 450 GB/s each way. A lower
# bound on collective time: the production mesh spans hosts on both axes
LINK_BW = 450e9
HBM_GIB = 80e9 / 2**30       # one card's 80 GB, in GiB

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")


def param_counts(arch: str) -> tuple[float, float]:
    """(total params N, active params N_active), from shapes only."""
    bundle = get_bundle(arch)
    total = sum(p.numel() for p in _leaves(bundle.meta_params()))
    cfg = bundle.cfg
    if cfg.n_experts:
        # active = total - (unused experts' share of MoE weights)
        E, K = cfg.n_experts, cfg.top_k
        moe = cfg.n_layers * E * 3 * cfg.d_model * cfg.d_ff
        active = total - moe * (1 - K / E)
        return float(total), float(active)
    return float(total), float(total)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def model_flops(arch: str, shape_name: str) -> float:
    """6*N_active*tokens for train; 2*N_active*tokens for prefill/decode."""
    cell = SHAPES[shape_name]
    _, n_active = param_counts(arch)
    if cell.kind == "train":
        # whisper: encoder S/2 + decoder S/2 tokens
        return 6.0 * n_active * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n_active * cell.global_batch * cell.seq_len
    # decode: one token per sequence
    return 2.0 * n_active * cell.global_batch


def load_cell(arch: str, shape: str, mesh: str = "16x16",
              engine: str = "naive", tag: str = "") -> dict | None:
    p = os.path.join(RESULTS_DIR, mesh, f"{arch}__{shape}__{engine}{tag}.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def roofline_row(arch: str, shape: str, mesh: str = "16x16",
                 engine: str = "naive", tag: str = "") -> dict | None:
    res = load_cell(arch, shape, mesh, engine, tag)
    if res is None or "skipped" in res or "error" in res:
        return {"arch": arch, "shape": shape,
                "skipped": res.get("skipped") if res else "missing"}
    return row_of(res, arch, shape, mesh, engine)


def row_of(res: dict, arch: str, shape: str, mesh: str = "16x16",
           engine: str = "naive") -> dict:
    """The roofline row of one dry-run artifact ``res``."""
    ex = res["extrapolated"]
    chips = res["n_devices"]
    t_comp = ex["flops"] / PEAK_FLOPS
    t_mem = ex["bytes_accessed"] / HBM_BW
    t_coll = ex["collective_bytes_per_device"] / LINK_BW
    # amortised DMC gather
    g = res.get("gather")
    T = 50
    if g:
        t_comp += g["flops"] / PEAK_FLOPS / T
        t_mem += g["bytes_accessed"] / HBM_BW / T
        t_coll += g["collective_bytes_per_device"] / LINK_BW / T
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dom = max(terms, key=terms.get)
    step_time = max(terms.values())
    mf = model_flops(arch, shape)
    total = ex["flops"] * chips
    useful = mf / total if total else 0.0
    # roofline fraction: useful model flops per second at the bound, vs peak
    mfu = mf / (step_time * chips * PEAK_FLOPS) if step_time > 0 else 0.0
    mem = res["full"]["memory"]
    per_dev_gib = (mem["argument_bytes"] + mem["temp_bytes"]
                   + mem["output_bytes"] - mem["alias_bytes"]) / 2**30
    return {"arch": arch, "shape": shape, "mesh": mesh, "engine": engine,
            "lever": _lever(arch, res["kind"], dom),
            "t_compute_s": t_comp, "t_memory_s": t_mem,
            "t_collective_s": t_coll, "dominant": dom,
            "est_step_s": step_time, "model_flops": mf,
            "useful_flops_ratio": useful, "roofline_fraction": mfu,
            "mem_per_dev_gib": per_dev_gib,
            "fits": per_dev_gib <= HBM_GIB,
            "n_groups": res.get("n_groups"),
            "host_s": res.get("host_s")}


def _lever(arch: str, kind: str, dominant: str) -> str:
    """One sentence per cell: the port's lever on the dominant term
    (PERF.md §7 and ROADMAP's speed items)."""
    cfg = get_bundle(arch).cfg
    if dominant == "collective":
        if kind == "train" and cfg.n_experts:
            return ("expert parallelism: E/M whole experts a rank and an "
                    "all-to-all of the routed tokens, in place of F split "
                    "over 'model' and a [T, D] reduction each layer")
        if kind == "train":
            return ("the 'model' axis's per-layer reductions dominate: split "
                    "the heads where they do not divide M, or fewer 'model' "
                    "ranks; ALIE's gathers and the Gram on a rank's 1/rep of "
                    "the columns")
        return ("batch the replicas' reductions and keep small leaves whole "
                "(one collective a layer, not one a leaf); fewer 'model' "
                "ranks for serving")
    if dominant == "memory":
        if kind in ("train", "prefill") and not cfg.subquadratic:
            return ("fuse the elementwise chains around the GEMMs (norms, "
                    "rotary, SwiGLU, the loss) and ALIE's std over [n, P]; "
                    "the flash kernels at hd 64")
        if kind == "decode":
            return ("CUDA-graph decode and batched replicas: decode streams "
                    "the cache and the weights once a token")
        return ("the scans (WKV, SSD) as kernels: their chunked plain "
                "versions move every state through HBM")
    return ("the aggregation's batched GEMV and fewer remat recomputes "
            "(the useful-flops ratio shows the headroom)")


def full_table(mesh: str = "16x16", engine: str = "naive", tag: str = ""):
    rows = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            rows.append(roofline_row(arch, shape, mesh, engine, tag))
    return [r for r in rows if r]


def format_table(rows) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'comp(s)':>9s} {'mem(s)':>9s} "
           f"{'coll(s)':>9s} {'dominant':>10s} {'MFU':>6s} {'useful':>7s} "
           f"{'GiB/dev':>8s} {'fits':>5s}")
    lines = ["reckoned from the dry run, H100 SXM published peaks "
             f"({PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16, {HBM_BW / 1e12:.2f} "
             f"TB/s HBM, NVLink {LINK_BW / 1e9:.0f} GB/s each way; "
             f"{HBM_GIB:.1f} GiB a card)", hdr, "-" * len(hdr)]
    for r in rows:
        if "skipped" in r:
            lines.append(f"{r['arch']:24s} {r['shape']:12s} SKIP: {r['skipped']}")
            continue
        lines.append(
            f"{r['arch']:24s} {r['shape']:12s} {r['t_compute_s']:9.4f} "
            f"{r['t_memory_s']:9.4f} {r['t_collective_s']:9.4f} "
            f"{r['dominant']:>10s} {r['roofline_fraction']:6.1%} "
            f"{r['useful_flops_ratio']:7.2f} {r['mem_per_dev_gib']:8.2f} "
            f"{'yes' if r.get('fits', True) else 'NO':>5s}")
        lines.append(f"{'':37s} -> {r['lever']}")
    return "\n".join(lines)


def main(argv=None):
    import argparse
    global RESULTS_DIR
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--engine", default="naive")
    ap.add_argument("--json", default=None)
    ap.add_argument("--tag", default="",
                    help="the artifacts' tag (dryrun's, e.g. __reduced)")
    ap.add_argument("--results-dir", default=None,
                    help=f"default: {os.path.normpath(RESULTS_DIR)}")
    args = ap.parse_args(argv)
    if args.results_dir:
        RESULTS_DIR = args.results_dir
    rows = full_table(args.mesh, args.engine, args.tag)
    print(format_table(rows))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()

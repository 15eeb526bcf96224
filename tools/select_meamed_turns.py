#!/usr/bin/env python3
"""The exact MDA selection and MeaMed kernels against their previous
versions, on one card, in turns.

    python3 tools/select_meamed_turns.py PARENT

PARENT is a checkout of an earlier commit of this repository (one unpacked
with ``git archive``) whose ``cwise_median.cu`` and ``mda_diameter.cu``
still hold the previous kernels: the MeaMed instance of the shared
order-statistic kernel, and the subset-diameter kernel with a thread per
(receiver, subset). The script builds both trees' sources with this tree's
``nvcc`` flags and prints, for each version:

- every kernel's ``ptxas`` registers, spill and stack frame, and its SASS
  instruction count (``cuobjdump -sass``, where the toolkit has it);
- MeaMed's device time at sync_filters' ``[5, 5, 1,093,642]``, f = 1, the
  two outputs bit-equal;
- the selection's device time at ``[5, 7, 7]`` (21 subsets), ``[4, 3, 3]``
  (3) and ``[1, 20, 20]`` with f = 8 (125,970): the previous diameter
  kernel followed by ``torch.argmin`` against the kernel that also takes
  the argmin and writes the weights, the diameters bit-equal.

Times are cold in L2 from a CUDA graph (``chip_smoke.cold_ms``), taken in
turns (previous, new, new, previous) and averaged. Needs one NVIDIA GPU and
``nvcc``.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

D = 1_093_642
SELECT_CASES = ((5, 7, 2), (4, 3, 1), (1, 20, 8))


def compile_lib(src: Path, out: Path):
    """``src`` built into ``out`` with the port's flags; its ptxas usage
    and SASS counts per kernel."""
    from repro_torch.kernels import _build
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(out), str(src)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc {src}:\n{proc.stdout}{proc.stderr}")
    return (ctypes.CDLL(str(out)),
            _build.ptxas_usage(proc.stdout + proc.stderr),
            _build.sass_counts(out))


def report(tag: str, usage: dict, sass: dict) -> None:
    import chip_smoke
    for fn, u in sorted(usage.items(),
                        key=lambda kv: chip_smoke.kernel_label(kv[0])):
        print(f"[{tag}] {chip_smoke.kernel_label(fn)}: "
              f"{chip_smoke.ptxas_text(u)}, "
              f"{sass.get(fn, 'not counted')} SASS instructions", flush=True)


def in_turns(fns: dict, args, iters: int) -> dict[str, float]:
    import chip_smoke
    names = list(fns)
    got = {k: [] for k in names}
    for k in names + names[::-1]:
        got[k].append(chip_smoke.cold_ms(fns[k], args, iters))
    return {k: sum(v) / len(v) for k, v in got.items()}


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available() or len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.cwise_median import ops as order_ops
    from repro_torch.kernels.mda_diameter import ops as diam_ops
    from repro_torch.kernels.pairwise_sqdist import ops as gram_ops
    from repro_torch.kernels.pairwise_sqdist.ref import sqdists_from_gram

    print(chip_smoke.card_line(), flush=True)
    parent = Path(argv[0]).resolve() / "src/repro_torch/kernels"
    out = _build.BUILD_DIR / "turns"
    libs = {}
    for pkg, src in (("cwise_median", "cwise_median/csrc/cwise_median.cu"),
                     ("mda_diameter", "mda_diameter/csrc/mda_diameter.cu")):
        for tag, tree in (("previous", parent), ("new", _build._HERE)):
            lib, usage, sass = compile_lib(tree / src,
                                           out / f"lib{pkg}-{tag}.so")
            report(f"{tag} {pkg}", usage, sass)
            libs[pkg, tag] = lib
    dev = torch.device("cuda")
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    old_meamed = libs["cwise_median", "previous"].cwise_meamed_f32
    old_meamed.argtypes, old_meamed.restype = [P, P, I, I, I, LL, P], I

    def meamed_previous(x):
        o = torch.empty((x.shape[0], x.shape[2]), device=dev)
        old_meamed(x.data_ptr(), o.data_ptr(), x.shape[0], x.shape[1], 1,
                   x.shape[2], _build.stream_ptr(x))
        return o

    g = torch.Generator(device=dev).manual_seed(55)
    x = 0.05 * torch.randn((5, 5, D), generator=g, device=dev)
    x[:, -1, ::97] = float("nan")
    if not torch.equal(meamed_previous(x), order_ops.cwise_meamed(x, 1)):
        raise AssertionError("MeaMed: the two versions differ")
    ms = in_turns({"previous": meamed_previous,
                   "new": lambda t: order_ops.cwise_meamed(t, 1)}, (x,), 100)
    bound = 4.0 * (5 * 5 * D + 5 * D) / chip_smoke.HBM_BPS * 1e3
    print(f"[turns] cwise_meamed [5, 5, {D}] f=1: previous "
          f"{ms['previous']:.4f} ms, new {ms['new']:.4f} ms (bound "
          f"{bound:.4f} ms: {100 * bound / ms['previous']:.1f} % / "
          f"{100 * bound / ms['new']:.1f} %)", flush=True)

    old_diam = libs["mda_diameter", "previous"].subset_diameters_f32
    old_diam.argtypes, old_diam.restype = [P, P, P, I, I, I, P], I
    for B, n, f in SELECT_CASES:
        masks = diam_ops.subset_masks(n, f)
        bits = diam_ops.bitmasks(masks, dev)
        S = bits.shape[0]

        def previous(t, bits=bits, S=S, n=n):
            o = torch.empty((t.shape[0], S), device=dev)
            old_diam(t.data_ptr(), bits.data_ptr(), o.data_ptr(), t.shape[0],
                     n, S, _build.stream_ptr(t))
            return o, torch.argmin(o, dim=-1)

        d2 = sqdists_from_gram(gram_ops.gram_plain(
            torch.randn((B, n, 64), generator=g, device=dev))).contiguous()
        diam_prev, best = previous(d2)
        diam, w = diam_ops.mda_select(d2, f)
        sel = torch.as_tensor(masks, device=dev)[best].float() / (n - f)
        if not (torch.equal(diam_prev, diam) and torch.equal(sel, w)):
            raise AssertionError(f"selection [{B}, {n}, {n}]: the two "
                                 f"versions differ")
        iters = 20 if S > 10_000 else 200
        ms = in_turns({"previous": previous,
                       "new": lambda t, f=f: diam_ops.mda_select(t, f)},
                      (d2,), iters)
        print(f"[turns] selection [{B}, {n}, {n}] f={f} x {S} subsets: "
              f"previous diameter kernel + torch.argmin "
              f"{ms['previous']:.4f} ms, one-launch selection "
              f"{ms['new']:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

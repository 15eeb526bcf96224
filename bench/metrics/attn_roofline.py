"""The flash-attention kernels' share of their roofline. The bound is the
least time the card could take for the attention the traced steps ask
of it: every forward the kernels ran (the loss's, and the one a
rematerialized block recomputes in its backward; counted from the
forward kernel's launches) and one backward a call, at the function's
own work (five products, not the dq and dkv kernels' seven), by the
frozen formulas at the shapes the configuration's family gives, bf16
operands, on the bf16 tensor-core peak. The time is the flash kernels'
device time by name in the traced steps. A family without attention
calls reads nothing."""
import re

from bench import yardstick as ys
from bench.reference import protocol as ref

UNIT = "%"
FWD = re.compile(r"(?<!\w)(flash_fwd|fwd)_kernel(?!\w)")
KERNELS = re.compile(r"(?<!\w)(flash_fwd|fwd|flash_bwd_dq|dq|flash_bwd_dkv|"
                     r"dkv)_kernel(?!\w)")


def read(run):
    c, tr, t = run.cell.config, run.cell.traffic, run.trace
    calls = ref.family(c).attention_calls(c, tr["batch_per_group"],
                                          tr["seq"])
    spent = sum(ns for name, ns in t.ops_ns.items() if KERNELS.search(name))
    if not calls or not spent:
        return None
    runs = tr["groups"] * t.steps            # a batch's pass through them
    forwards = sum(n for name, n in t.ops_n.items() if FWD.search(name))
    fwd = sum(ys.bound_s(*ys.flash_fwd_work(**s, itemsize=2), ys.PEAK_BF16)
              for s in calls)
    bwd = sum(ys.bound_s(*ys.flash_bwd_work(**s, itemsize=2), ys.PEAK_BF16)
              for s in calls)
    need = fwd * forwards / len(calls) + bwd * runs
    return 100.0 * need / (spent / 1e9)

"""The aggregation kernels' share of their roofline: the least time the
card could take for the calls the cell's shapes imply (each step's pull,
a median over ``[G, q_ps, P]``; its Gram of ``[G, P]``; MDA's selection
for G servers over their push quorums; each DMC gather, a median over
``[G, q_ps, P]``), by the frozen work formulas in float32 (the peak
outside the tensor cores), over the device time of the median, Gram and
selection kernels by name in the traced steps."""
import re

from bench import yardstick as ys
from bench.reference import protocol as ref

UNIT = "%"
KERNELS = re.compile(r"(?<!\w)(order_stat|gram_reg|gram_partial|gram_finish|"
                     r"mda_select)_kernel(?!\w)")


def read(run):
    c, tr, t = run.cell.config, run.cell.traffic, run.trace
    P = sum(n for *_, n in ref.spans(c))
    G, f_w = tr["groups"], tr["f_workers"]
    q_w, q_ps = G - f_w, G - tr["f_servers"]
    median = ys.bound_s(*ys.median_work(G, q_ps, P), ys.PEAK_F32)
    per_step = (median + ys.bound_s(*ys.gram_work(1, G, P), ys.PEAK_F32)
                + ys.bound_s(*ys.select_work(G, q_w, ys.n_subsets(q_w, f_w),
                                             q_w - f_w), ys.PEAK_F32))
    need = per_step * t.steps + median * t.gathers
    spent = sum(ns for name, ns in t.ops_ns.items() if KERNELS.search(name))
    return 100.0 * need / (spent / 1e9) if spent else None

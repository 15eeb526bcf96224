"""The reduction of a ``torch.profiler`` window to what the per-layer
metrics read: the device's operations by name, their busy union, the idle
gaps by what the host was doing, and the device time of named ranges.

It reads the raw records (``prof.profiler.kineto_results.events()``) in
one pass, building no ``FunctionEvent`` and no tree: ``key_averages()``
takes minutes on a window of a few hundred thousand records. A range's
device time is that of the kernels launched by the operations inside the
range on its thread, and by the backward nodes of those operations
(matched by autograd sequence number) with everything inside them, the
recomputation of checkpointed blocks included.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import torch

WINDOW = "bench.window"      # the range around the traced steps
STEP = "bench.step"          # the range around each of them
BACKWARD = "autograd::engine::evaluate"


@dataclass
class Trace:
    window_ns: int                         # the traced window's length
    busy_ns: int                           # the device's busy union in it
    ops_ns: dict = field(default_factory=dict)       # device op -> ns
    ops_n: dict = field(default_factory=dict)        # device op -> launches
    range_ns: dict = field(default_factory=dict)     # range -> device ns
    gaps_ns: dict = field(default_factory=dict)      # host op -> idle ns
    steps: int = 0                         # whole steps in the window
    gathers: int = 0                       # DMC gathers among them

    @property
    def device_ns(self) -> int:
        return sum(self.ops_ns.values())

    def breakdown(self, n: int = 10) -> dict:
        def top(d):
            return [[k, v / 1e9] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:n]]
        return {"device_ops": top(self.ops_ns), "idle_gaps": top(self.gaps_ns)}


def _union(intervals):
    """Merged ``[(start, end)]`` of intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events, ranges=()) -> Trace:
    """A :class:`Trace` of the raw records ``events`` of a window marked
    by a :data:`WINDOW` range, with the device time of each range named in
    ``ranges``."""
    cpu = torch.autograd.DeviceType.CPU
    kernels = []                    # (start, end, name, linked id)
    ops: dict = {}                  # thread -> [(start, end, id, seq, name)]
    marked, roots, window = [], [], None
    for e in events:
        if e.device_type() != cpu:
            if not e.is_user_annotation():
                kernels.append((e.start_ns(), e.end_ns(), e.name(),
                                e.linked_correlation_id()))
            continue
        if e.linked_correlation_id() > 0:        # a runtime call of an op
            continue
        rec = (e.start_ns(), e.end_ns(), e.correlation_id(), e.sequence_nr(),
               e.name())
        thread = e.start_thread_id()
        ops.setdefault(thread, []).append(rec)
        if e.name() == WINDOW:
            window = (thread, rec)
        elif e.name() in ranges:
            marked.append((e.name(), thread, rec))
        elif e.name().startswith(BACKWARD):
            roots.append((thread, rec))
    if window is None:
        raise ValueError(f"no {WINDOW!r} range in the trace")
    w0, w1 = window[1][:2]
    for v in ops.values():
        v.sort()
    starts = {t: [r[0] for r in v] for t, v in ops.items()}

    def inside(thread, rec):
        v = ops[thread]
        lo = bisect.bisect_left(starts[thread], rec[0])
        hi = bisect.bisect_right(starts[thread], rec[1])
        return [r for r in v[lo:hi] if r[1] <= rec[1]]

    tr = Trace(window_ns=w1 - w0, busy_ns=0)
    by_link: dict = {}
    busy = _union((max(a, w0), min(b, w1)) for a, b, _, _ in kernels
                  if b > w0 and a < w1)
    tr.busy_ns = sum(b - a for a, b in busy)
    for a, b, name, link in kernels:
        if b > w0 and a < w1:
            tr.ops_ns[name] = tr.ops_ns.get(name, 0) + (b - a)
            tr.ops_n[name] = tr.ops_n.get(name, 0) + 1
            by_link[link] = by_link.get(link, 0) + (b - a)
    for name in ranges:
        fwd = {r[2]: r for n, t, rec in marked if n == name
               for r in inside(t, rec)}
        seqs = {r[3] for r in fwd.values() if r[3] >= 0}
        bwd = {r[2] for t, rec in roots if rec[3] in seqs
               for r in inside(t, rec) if r[2] not in fwd}
        tr.range_ns[name] = sum(by_link.get(i, 0) for i in (*fwd, *bwd))
    # each idle gap, by the innermost host op running at its middle on the
    # thread that ran the steps (the ops of one thread nest: a stack)
    main = ops[window[0]]
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    stack, i = [], 0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        while i < len(main) and main[i][0] <= mid:
            while stack and stack[-1][1] < main[i][0]:
                stack.pop()
            stack.append(main[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        host = stack[-1][4] if stack else WINDOW
        host = "python, in no op" if host in (WINDOW, STEP) else host
        tr.gaps_ns[host] = tr.gaps_ns.get(host, 0) + (b - a)
    return tr

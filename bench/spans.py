"""The program's own spans in a profiled window of whole steps: each span's
device time (its own, and with the spans nested in it), its kernel
launches, the card's idle time while the stepping thread is inside it,
the marks the program counts, and what falls outside every span.

    python3 -m bench.spans --workload <cell> --seed <n>

runs the cell's set-up, two DMC periods of whole steps on the host clock,
and one under ``torch.profiler`` (with the ranges its per-layer metrics
name, as a ``--trace 1`` run), then prints the span table, the numbers
read from it, the same window's per-layer metrics as :mod:`bench.run`
reads them, and where the spans and the ranges part (standard error;
the last line of standard output is one JSON object).

The port names its spans itself (``repro_torch.spans``: the ``byzsgd.*``
phases of the train step, ``rwkv6.wkv``, ``mamba2.ssd``) and counts
device-to-host reads with the mark ``byzsgd.host_sync``. Each kernel
goes to one span: the innermost span open on the thread of the op that
launched it (of the launch call, for a kernel of no op), or, for an op
inside a backward node (an ``autograd::engine::evaluate_function``
record), the span of the forward op that made the node. That op is the
last one on the node's forward thread to carry the node's sequence
number. The number is a per-thread counter that every op dispatched
through autograd records, whether it makes a node or not: the ops of a
phase that differentiates nothing carry the number of the next node
made after them (the next group's embedding), and a rematerialized
block's recompute, on autograd's thread, carries that thread's numbers,
which other nodes of the main thread also have. Matched to every op
that carried it on any thread, as :func:`bench.trace.reduce` matches a
range's, a node's backward counts in each of those spans. Each idle gap
goes to the innermost span open on the stepping thread at its middle.
"""
from __future__ import annotations

import argparse
import bisect
import json
import re
import sys
import time
from collections import Counter
from dataclasses import dataclass, field

import torch

from . import trace

#: prefixes of the spans the port emits
PROGRAM = ("byzsgd.", "rwkv6.", "mamba2.")
#: the marks the port emits: zero-length ranges, counted
MARKS = ("byzsgd.host_sync",)
OUTSIDE = "(outside every span)"
#: the train step's phases, each a span directly inside ``byzsgd.step``
PHASES = ("byzsgd.pull", "byzsgd.attack", "byzsgd.select",
          "byzsgd.aggregate", "byzsgd.update", "byzsgd.gather")
STEP, MODEL, FLATTEN = "byzsgd.step", "byzsgd.model", "byzsgd.flatten"
#: the host's calls into the CUDA runtime and driver (``cudaLaunchKernel``,
#: ``cuLaunchKernel``, ...)
RUNTIME = re.compile(r"cu(da)?[A-Z]")


@dataclass
class Spans:
    window_ns: int
    busy_ns: int
    steps: int
    self_ns: dict = field(default_factory=dict)    # span -> device ns
    launches: dict = field(default_factory=dict)   # span -> kernels
    idle_ns: dict = field(default_factory=dict)    # innermost span -> ns
    calls: dict = field(default_factory=dict)      # span or mark -> records
    parent: dict = field(default_factory=dict)     # span -> enclosing span
    kernels: list = field(default_factory=list)    # reduce(detail=True)

    @property
    def device_ns(self) -> int:
        return sum(self.self_ns.values())

    def children(self, name) -> list:
        return [s for s, p in self.parent.items() if p == name]

    def _total(self, d: dict, name: str) -> int:
        seen, todo, out = set(), [name], 0
        while todo:
            s = todo.pop()
            if s not in seen:
                seen.add(s)
                out += d.get(s, 0)
                todo += self.children(s)
        return out

    def total_ns(self, name: str) -> int:
        """Device ns of ``name`` with every span nested in it."""
        return self._total(self.self_ns, name)

    def idle_total_ns(self, name: str) -> int:
        return self._total(self.idle_ns, name)

    def ms(self, ns) -> float:
        return ns / self.steps / 1e6

    def numbers(self) -> dict:
        """The per-step numbers the spans give (``None``: not opened)."""
        out = {}
        for name in PHASES:
            key = name.split(".")[1] + "_ms_per_step"
            out[key] = (self.ms(self.total_ns(name)) if self.calls.get(name)
                        else None)
        if self.calls.get(MODEL):
            model = self.idle_total_ns(MODEL)
            out["model_idle_ms_per_step"] = self.ms(model)
            out["protocol_idle_ms_per_step"] = self.ms(
                self.idle_total_ns(STEP) - self.idle_ns.get(STEP, 0) - model)
        if self.calls.get(STEP):
            out["host_syncs_per_step"] = self.calls.get(MARKS[0], 0) \
                / self.steps
        return out

    def lines(self) -> list[str]:
        """The table: each span's device ms a step (its own, and with its
        nested spans), idle ms a step (innermost, and with its nested
        spans), launches a step and records, nested spans indented."""
        head = (f"{'span':<30} {'device ms/step':>19} {'idle ms/step':>17} "
                f"{'launches/step':>14} {'records':>8}")
        out = [head, f"{'':<30} {'own':>9} {'nested':>9} {'own':>8} "
                     f"{'nested':>8}"]

        def row(name, depth):
            label = ("  " * depth + name)[:30]
            out.append(
                f"{label:<30} {self.ms(self.self_ns.get(name, 0)):9.3f} "
                f"{self.ms(self.total_ns(name)):9.3f} "
                f"{self.ms(self.idle_ns.get(name, 0)):8.3f} "
                f"{self.ms(self.idle_total_ns(name)):8.3f} "
                f"{self.launches.get(name, 0) / self.steps:14.1f} "
                f"{self.calls.get(name, 0):8d}")
            for c in self.children(name):
                row(c, depth + 1)

        for name in self.children(None):
            row(name, 0)
        for name in MARKS:
            out.append(f"{name:<30} {'(mark)':>19} {'':>17} {'':>14} "
                       f"{self.calls.get(name, 0):8d}")
        rest = (self.ms(self.self_ns.get(OUTSIDE, 0)),
                self.ms(self.idle_ns.get(OUTSIDE, 0)),
                self.launches.get(OUTSIDE, 0) / self.steps)
        out.append(f"{OUTSIDE:<30} {rest[0]:9.3f} {'':>9} {rest[1]:8.3f} "
                   f"{'':>8} {rest[2]:14.1f}")
        out.append(f"device {self.ms(self.device_ns):.3f} ms a step, idle "
                   f"{self.ms(self.window_ns - self.busy_ns):.3f}, window "
                   f"{self.ms(self.window_ns):.3f}, {self.steps} steps")
        return out


def _program(name: str, prefixes) -> bool:
    return name.startswith(prefixes) and name not in MARKS


def reduce(events, steps: int, prefixes=PROGRAM,
           detail: bool = False) -> Spans:
    """The :class:`Spans` of the raw records ``events`` of a window marked
    by a :data:`bench.trace.WINDOW` range holding ``steps`` steps. A
    kernel goes to its op's span, or, where it links to no op (a kernel
    library called through ``ctypes`` launches outside every op), to the
    span open at its launch call on the launching thread. ``detail``
    keeps each kernel's ``(name, ns, span, how, linked op id)`` in
    ``Spans.kernels`` (``how``: "launch", "op" or ``None``)."""
    cpu = torch.autograd.DeviceType.CPU
    kernels = []            # (start, end, linked op id, launch id, name)
    recs = []               # (start, -end, thread, seq, fwd thread, id,
    window = None           #  name, a launch call)
    for e in events:
        if e.device_type() != cpu:
            if not e.is_user_annotation():
                kernels.append((e.start_ns(), e.end_ns(),
                                e.linked_correlation_id(),
                                e.correlation_id(), e.name()))
            continue
        launch = (e.linked_correlation_id() > 0
                  or RUNTIME.match(e.name()) is not None)
        rec = (e.start_ns(), -e.end_ns(), e.start_thread_id(),
               e.sequence_nr(), e.fwd_thread_id(), e.correlation_id(),
               e.name(), launch)
        recs.append(rec)
        if e.name() == trace.WINDOW:
            window = rec
    if window is None:
        raise ValueError(f"no {trace.WINDOW!r} range in the trace")
    w0, w1, main = window[0], -window[1], window[2]
    # one pass in start order, a stack of open spans (and resolved
    # backward nodes) per thread: an op's owner is the top of its stack
    recs.sort()
    owner: dict = {}                    # op id -> span (None: outside)
    at_launch: dict = {}                # launch id -> span
    last: dict = {}                     # (thread, seq) -> the span of the
    stacks: dict = {}                   # last forward op that carried it
    votes: dict = {}
    calls: Counter = Counter()
    spans_main = []
    for start, neg_end, thread, seq, fwd, cid, name, launch in recs:
        end = -neg_end
        stack = stacks.setdefault(thread, [])
        while stack and stack[-1][0] < end:
            stack.pop()
        own = stack[-1][1] if stack else None
        if launch:
            at_launch[cid] = own
            continue
        owner[cid] = own
        if name.startswith(prefixes):
            calls[name] += 1
        if _program(name, prefixes):
            if own != name:         # a recompute inside its own node
                votes.setdefault(name, Counter())[own] += 1
            stack.append((end, name))
            if thread == main:
                spans_main.append((start, end, name))
        elif name.startswith(trace.BACKWARD):
            if seq >= 0 and (fwd, seq) in last:
                stack.append((end, last[(fwd, seq)]))
        elif seq >= 0 and fwd == 0:
            last[(thread, seq)] = own
    sp = Spans(window_ns=w1 - w0, busy_ns=0, steps=steps, calls=dict(calls),
               parent={n: v.most_common(1)[0][0] for n, v in votes.items()})
    for a, b, link, cid, kname in kernels:
        if b > w0 and a < w1:
            if link in owner:
                name, how = owner[link], "op"
            else:
                name, how = at_launch.get(cid), (
                    "launch" if cid in at_launch else None)
            name = name or OUTSIDE
            sp.self_ns[name] = sp.self_ns.get(name, 0) + (b - a)
            sp.launches[name] = sp.launches.get(name, 0) + 1
            if detail:
                sp.kernels.append((kname, b - a, name, how, link))
    busy = trace._union((max(a, w0), min(b, w1)) for a, b, *_ in kernels
                        if b > w0 and a < w1)
    sp.busy_ns = sum(b - a for a, b in busy)
    # each idle gap, by the innermost span open at its middle on the
    # stepping thread (the spans of one thread nest: a stack)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    stack, i = [], 0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        while i < len(spans_main) and spans_main[i][0] <= mid:
            while stack and stack[-1][1] < spans_main[i][0]:
                stack.pop()
            stack.append(spans_main[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else OUTSIDE
        sp.idle_ns[name] = sp.idle_ns.get(name, 0) + (b - a)
    return sp


def checks(sp: Spans, tr: trace.Trace, naive: trace.Trace) -> dict:
    """The spans against what the benchmark measures from outside, in ms a
    step: ``tr`` is the window as :func:`bench.trace.reduce` reads it with
    the per-layer metrics' ranges, ``naive`` with the phases' spans as
    ranges (every op that carried a node's number matched to it)."""
    ms, num = sp.ms, sp.numbers()
    model = sp.total_ns(MODEL)
    phases = sum(sp.total_ns(p) for p in PHASES)
    out = {"protocol_ms_per_step (device - range model)":
           ms(tr.device_ns - tr.range_ns.get("model", 0)),
           "phases + flatten + rest (device - byzsgd.model)":
           ms(sp.device_ns - model),
           "phases": ms(phases), "flatten": ms(sp.total_ns(FLATTEN)),
           "rest (step, grads' own, outside)":
           ms(sp.device_ns - model - phases - sp.total_ns(FLATTEN)),
           "range model": ms(tr.range_ns.get("model", 0)),
           "byzsgd.model": ms(model),
           "idle": ms(sp.window_ns - sp.busy_ns),
           "idle: model + protocol + outside": sum(
               num.get(k) or 0.0 for k in ("model_idle_ms_per_step",
                                          "protocol_idle_ms_per_step"))
           + ms(sum(sp.idle_ns.values()) - sp.idle_total_ns(STEP)
                + sp.idle_ns.get(STEP, 0))}
    if "wkv" in tr.range_ns:
        out["range wkv"] = ms(tr.range_ns["wkv"])
        out["rwkv6.wkv"] = ms(sp.total_ns("rwkv6.wkv"))
    for p in PHASES:
        out[f"{p} as a range (every op's number)"] = ms(
            naive.range_ns.get(p, 0))
    return out


def _range_ops(events, name: str) -> dict:
    """Op id -> how :func:`bench.trace.reduce` counts the op in the range
    ``name``: ``name`` for an op inside one, else the backward node that
    holds it (every node whose number an op inside carried)."""
    cpu = torch.autograd.DeviceType.CPU
    ops, marked, roots = {}, [], []
    for e in events:
        if e.device_type() != cpu or e.linked_correlation_id() > 0:
            continue
        rec = (e.start_ns(), e.end_ns(), e.correlation_id(),
               e.sequence_nr(), e.name())
        ops.setdefault(e.start_thread_id(), []).append(rec)
        if e.name() == name:
            marked.append((e.start_thread_id(), rec))
        elif e.name().startswith(trace.BACKWARD):
            roots.append((e.start_thread_id(), rec))
    for v in ops.values():
        v.sort()
    starts = {t: [r[0] for r in v] for t, v in ops.items()}

    def within(thread, rec):
        lo = bisect.bisect_left(starts[thread], rec[0])
        hi = bisect.bisect_right(starts[thread], rec[1])
        return [r for r in ops[thread][lo:hi] if r[1] <= rec[1]]

    fwd = [r for t, rec in marked for r in within(t, rec)]
    out = {r[2]: name for r in fwd}
    seqs = {r[3] for r in fwd if r[3] >= 0}
    for t, rec in roots:
        if rec[3] in seqs:
            node = rec[4].split(": ", 1)[-1]
            for r in within(t, rec):
                out.setdefault(r[2], node)
    return out


def diverging(events, sp: Spans, range_name: str, span: str,
              top: int = 8) -> list:
    """Where the range ``range_name`` (as :func:`bench.trace.reduce`
    reads it) and the span ``span`` (with its nested spans) part: ``[how
    the range holds the kernels, the span they go to, ms a step]``, the
    largest first; the span's kernels outside the range come as ``[None,
    span, ms]``. Needs ``reduce(..., detail=True)``."""
    ids = _range_ops(events, range_name)
    out: Counter = Counter()
    for _, ns, owner, _, link in sp.kernels:
        inside = _below(sp, owner, span)
        if link in ids and not inside:
            out[(ids[link], owner)] += ns
        elif inside and link not in ids:
            out[(None, owner)] += ns
    return [[how, owner, sp.ms(ns)]
            for (how, owner), ns in out.most_common(top)]


def _below(sp: Spans, s, name) -> bool:
    while s is not None:
        if s == name:
            return True
        s = sp.parent.get(s)
    return False


def main(argv=None) -> int:
    from . import program, spec
    from .run import RunView, _free, _sync, card_line, checked_steps

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    print(f"[spans] card: {card_line()}", file=sys.stderr)
    program.build_kernels()
    torch.cuda.set_device(dev)
    prog, feed, _, _ = checked_steps(cell, args.seed, dev)
    _free(dev)
    T = prog.tr["T"]

    def steps():
        batches = [feed.next() for _ in range(T)]
        _sync(dev)
        tic = time.perf_counter()
        with torch.profiler.record_function(trace.WINDOW):
            for b in batches:
                with torch.profiler.record_function(trace.STEP):
                    prog.step(b)
            _sync(dev)
        return (time.perf_counter() - tic) / T * 1e3

    plain = [steps() for _ in range(2)]
    targets = {}
    for mod in cell.layers.values():
        targets.update(getattr(mod, "RANGES", {}))
    from torch.profiler import ProfilerActivity, profile
    with prog.ranges_on(targets), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_ms = steps()
    events = list(prof.profiler.kineto_results.events())
    del prof
    tr = trace.reduce(events, tuple(targets))
    tr.steps, tr.gathers = T, 1
    naive = trace.reduce(events, PHASES)
    sp = reduce(events, T, detail=True)
    parts = {f"{r} against {s}": diverging(events, sp, r, s)
             for r, s in (("model", MODEL), ("wkv", "rwkv6.wkv"))
             if r in targets}
    del events
    view = RunView(cell, 0.0, T, 1.0, 0, tr)
    layers = {n: m.read(view) for n, m in cell.layers.items()
              if n not in ("mfu", "peak_mem_gb")}
    how, outside = Counter(), Counter()
    for kname, ns, owner, via, _ in sp.kernels:
        how[str(via)] += ns
        if owner == OUTSIDE:
            outside[kname[:80]] += ns
    out = {"cell": cell.name, "seed": args.seed,
           "step_ms": {"untraced": plain, "traced": traced_ms},
           "spans": sp.numbers(), "layers": layers,
           "checks": checks(sp, tr, naive), "parts": parts,
           "kernels_by": {k: sp.ms(v) for k, v in how.items()},
           "outside": [[k, sp.ms(v)] for k, v in outside.most_common(8)],
           "idle_gaps": tr.breakdown()["idle_gaps"]}
    print("\n".join(f"[spans] {line}" for line in sp.lines()),
          file=sys.stderr)
    for k in ("step_ms", "spans", "layers", "checks", "parts", "kernels_by",
              "outside"):
        print(f"[spans] {k}: " + json.dumps(out[k]), file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

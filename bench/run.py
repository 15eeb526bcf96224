"""Run one cell of the benchmark once:

    python -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the checkout's root. Set-up builds the program's training step and
state from the seed's inputs and drives it through the checked steps; the
window then steps until ``--seconds`` have passed and ends at a
synchronize; with ``--trace 1`` a profiled window of one DMC period of
whole steps follows. Once the program's state is freed, the plain
reference follows the checked steps on the same inputs, and the
comparison decides ``correct``. The last line of standard output is the
result, one JSON object; the last lines of standard error give each
number compared beside its limit.

It exits with 2, printing no result, without as many CUDA cards as the
cell asks for, and with 3 if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()     # set-up counts from here

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

import torch  # noqa: E402

from . import compare, inputs, spec, trace  # noqa: E402
from .program import Program, build_kernels, port  # noqa: E402
from .reference import protocol as ref  # noqa: E402

IMPORTED = time.perf_counter()

#: top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class RunView:
    """What a metric's reader reads."""
    cell: spec.Cell
    setup_s: float
    steps: int                  # steps in the measured window
    seconds: float              # the window's length
    memory_peak_bytes: int
    trace: trace.Trace | None = None


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read (no nvidia-smi)"


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def checked_steps(cell: spec.Cell, seed: int, device, *, fault=None,
                  clock=None):
    """Set-up: the program from the seed's inputs, driven through the
    checked steps. Returns the program, the token feed, the checked
    steps' batches and the program's readings (``losses``, ``first``,
    ``change``, ``picks``: :mod:`bench.compare`'s). ``clock`` (a dict)
    gets the seconds of each part."""
    clock = {} if clock is None else clock
    tr, c = cell.traffic, cell.config
    tic = time.perf_counter()
    port()
    clock["program imports"] = time.perf_counter() - tic
    tic = time.perf_counter()
    prog = Program(cell, seed, device, fault=fault)
    feed = inputs.TokenFeed(seed, c["vocab_size"], tr, device)
    eta0 = ref.lr(tr["t0"], tr["lr"], tr["lr_decay"])
    _sync(device)
    clock["program"] = time.perf_counter() - tic
    batches, first = [], None
    prog.recording = True
    with prog.picks_read():
        for s in range(inputs.check_steps(tr)):
            tic = time.perf_counter()
            batches.append(feed.next())
            prog.step(batches[-1])
            _sync(device)
            clock[f"step {s + 1}"] = time.perf_counter() - tic
            if s == 0:      # the first aggregated gradient, as taken
                first = prog.readings(inputs.make_weights(c, seed,
                                                          device)) / eta0
    prog.recording = False
    tic = time.perf_counter()
    readings = dict(losses=prog.losses_read(), first=first,
                    change=prog.readings(inputs.make_weights(c, seed,
                                                             device)),
                    picks=prog.picks)
    clock["readings"] = time.perf_counter() - tic
    return prog, feed, batches, readings


def reference(cell: spec.Cell, seed: int, device, batches, picks) -> dict:
    """The plain reference's readings of the checked steps, following the
    program's MDA ``picks``."""
    c, tr = cell.config, cell.traffic
    return ref.run(c, tr, inputs.make_weights(c, seed, device), batches,
                   inputs.quorum_tables(seed, tr), len(batches), picks)


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
        *, fault=None, log=print) -> dict:
    """One run of ``cell`` on ``device``; returns the result's fields."""
    clock = {"imports": IMPORTED - T0}
    tic = time.perf_counter()
    if device.type == "cuda":
        build_kernels()
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    clock["kernels and context"] = time.perf_counter() - tic
    prog, feed, batches, readings = checked_steps(
        cell, seed, device, fault=fault, clock=clock)
    _free(device)
    _sync(device)
    setup_s = time.perf_counter() - T0
    log(f"[bench] {cell.name}: set-up {setup_s:.2f} s: " + ", ".join(
        f"{k} {v:.2f}" for k, v in clock.items()), file=sys.stderr)

    t_start = time.perf_counter()
    steps = 0
    while True:
        prog.step(feed.next())
        steps += 1
        if time.perf_counter() - t_start >= seconds:
            break
    _sync(device)
    window = time.perf_counter() - t_start
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    view = RunView(cell, setup_s, steps, window, peak)

    readers = cell.layers if traced else cell.metrics
    if traced:
        view.trace = _traced(prog, feed, readers, device)
        log("[bench] traced device ops (s, launches): " + "; ".join(
            f"{name[:60]} {ns / 1e9:.4f} {view.trace.ops_n[name]}"
            for name, ns in sorted(view.trace.ops_ns.items(),
                                   key=lambda kv: -kv[1])[:12]),
            file=sys.stderr)

    prog.free()
    del prog, feed
    _free(device)
    t_ref = time.perf_counter()
    want = reference(cell, seed, device, batches, readings["picks"])
    numbers = compare.gaps(readings, want, cell.limits)
    log(f"[bench] {cell.name}: reference {time.perf_counter() - t_ref:.1f} s"
        f" for {len(batches)} steps, MDA's least margin "
        f"{want['mda_margin']:.3g}, picks other than the reference's best "
        f"{want['other_picks']}", file=sys.stderr)
    metrics = {}
    for name, mod in readers.items():
        value = mod.read(view)
        if value is not None:
            metrics[name] = {"value": value, "unit": mod.UNIT}
    out = {"correct": compare.verdict(numbers, cell.limits),
           "attempted": steps, "failed": 0, "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                      "kind": (torch.cuda.get_device_name(device)
                               if device.type == "cuda" else "cpu"),
                      "count": 1, "memory_peak_bytes": peak}}
    if traced:
        out["device"]["busy_s"] = view.trace.busy_ns / 1e9
        out["device"]["window_s"] = view.trace.window_ns / 1e9
        out["breakdown"] = view.trace.breakdown()
    out["check"] = {k: {"value": numbers[k],
                        "limit": cell.limits[k]["limit"]}
                    for k in compare.compared(cell.limits)}
    return out


def _traced(prog, feed, readers, device) -> trace.Trace:
    """One DMC period of whole steps under ``torch.profiler``, with the
    ranges the readers name, reduced to a :class:`trace.Trace`."""
    from torch.profiler import ProfilerActivity, profile
    targets = {}
    for mod in readers.values():
        targets.update(getattr(mod, "RANGES", {}))
    T = prog.tr["T"]
    batches = [feed.next() for _ in range(T)]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device.type == "cuda" else [])
    _sync(device)
    with prog.ranges_on(targets), profile(activities=acts) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            for b in batches:
                with torch.profiler.record_function(trace.STEP):
                    prog.step(b)
            _sync(device)
    events = list(prof.profiler.kineto_results.events())
    tr = trace.reduce(events, tuple(targets))
    tr.steps, tr.gathers = T, 1       # T whole steps hold one DMC gather
    del events, prof
    return tr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"[bench] {cell.name} needs {cell.chips} CUDA card(s); this "
              f"machine has {have}", file=sys.stderr)
        return 2
    print(f"[bench] card: {card_line()}", file=sys.stderr)
    out = run(cell, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"[bench] loaded in this process: {bad}", file=sys.stderr)
        return 3
    print("\n".join(compare.lines(
        {k: v["value"] for k, v in out["check"].items()}, cell.limits)),
        file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

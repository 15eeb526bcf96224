"""The reduction of the program's own spans (:mod:`bench.spans`) on
hand-worked records: each span's device time, its idle time and the
marks, with backward nodes matched to the span of the op that made them;
the program's spans leave :func:`bench.trace.reduce`'s numbers as they
were but for the labels of the idle gaps; and on a tiny cell's traced
steps on the CPU, the spans the program opens and how they nest."""
from __future__ import annotations

import pytest
import torch

from bench import spans, trace

from conftest import make_root, tiny_cell

_BWD = "autograd::engine::evaluate_function: "


class _E:
    """A raw profiler record."""

    def __init__(self, name, start, end, *, thread=1, device=False,
                 corr=0, link=0, seq=-1, fwd=0, note=False):
        self._v = dict(name=name, start_ns=start, end_ns=end,
                       duration_ns=end - start, start_thread_id=thread,
                       correlation_id=corr, linked_correlation_id=link,
                       sequence_nr=seq, fwd_thread_id=fwd,
                       is_user_annotation=note,
                       device_type=(torch.autograd.DeviceType.CUDA if device
                                    else torch.autograd.DeviceType.CPU))

    def __getattr__(self, k):
        return lambda: self._v[k]


def _k(name, start, end, link, corr=0):
    return _E(name, start, end, device=True, link=link, corr=corr)


#: one step: the pull's op carries the number (5) of the node the
#: embedding makes later; the WKV scan's span opens in the forward and in
#: the recompute on autograd's thread (2), inside the backward node of its
#: own op (6), where its op carries autograd's thread's number (0), which
#: a node of the main thread has too; a kernel launched by no op (a
#: library called through
#: ctypes) goes to the span of its launch call; a kernel falls outside
#: every span
PROGRAM = [
    _E("byzsgd.step", 10, 990, corr=3, note=True),
    _E("byzsgd.pull", 20, 100, corr=4, note=True),
    _E("aten::index_select", 30, 40, corr=11, seq=5),
    _E("byzsgd.host_sync", 50, 50, corr=5, note=True),
    _E("byzsgd.grads", 110, 600, corr=6, note=True),
    _E("byzsgd.model", 120, 500, corr=7, note=True),
    _E("rwkv6.wkv", 145, 195, corr=9, note=True),
    _E("byzsgd.flatten", 510, 590, corr=10, note=True),
    _E("byzsgd.select", 610, 700, corr=12, note=True),
    _E("rwkv6.wkv", 206, 229, thread=2, corr=62, note=True),
]
OTHER = [
    _E(trace.WINDOW, 0, 1000, corr=1, note=True),
    _E(trace.STEP, 0, 1000, corr=2, note=True),
    _E("model", 120, 200, corr=8, note=True),
    _E("aten::logsumexp", 121, 123, corr=23, seq=0),
    _E("aten::embedding", 130, 140, corr=21, seq=5),
    _E("aten::mul", 150, 155, corr=22, seq=6),
    _E("aten::copy_", 512, 520, corr=31, seq=7),
    _E("aten::mm", 615, 625, corr=41, seq=7),
    _E("aten::zero_", 995, 998, corr=51, seq=7),
    _E(_BWD + "MulBackward0", 205, 300, thread=2, corr=61, seq=6, fwd=1),
    _E("aten::mul", 207, 209, thread=2, corr=63, seq=0),
    _E("aten::mul", 240, 250, thread=2, corr=64),
    _E(_BWD + "EmbeddingBackward0", 310, 400, thread=2, corr=65, seq=5,
       fwd=1),
    _E("aten::embedding_dense_backward", 315, 320, thread=2, corr=66),
    _E(_BWD + "LogsumexpBackward0", 410, 450, thread=2, corr=67, seq=0,
       fwd=1),
    _E("aten::exp", 412, 415, thread=2, corr=68),
    _k("k_lse", 450, 470, 68),
    _E("cudaLaunchKernel", 33, 34, link=11, corr=902),
    _k("k_pull", 35, 60, 11, corr=902), _k("k_emb", 140, 160, 21),
    _k("k_wkv", 160, 200, 22), _k("k_wkv_re", 230, 240, 63),
    _k("k_mul_bwd", 250, 280, 64), _k("k_emb_bwd", 320, 380, 66),
    _k("k_flat", 515, 560, 31), _k("k_mm", 620, 650, 41),
    _k("k_out", 996, 999, 51),
    _E("cuLaunchKernel", 660, 665, corr=901),
    _k("k_gram", 670, 690, 0, corr=901),
    _E("model", 120, 200, device=True, note=True),     # its device span
]


def test_spans_by_hand():
    sp = spans.reduce(PROGRAM + OTHER, steps=1)
    assert (sp.window_ns, sp.busy_ns) == (1000, 303)
    assert sp.self_ns == {"byzsgd.pull": 25, "byzsgd.model": 80 + 20,
                          "rwkv6.wkv": 80, "byzsgd.flatten": 45,
                          "byzsgd.select": 30 + 20, spans.OUTSIDE: 3}
    assert sp.parent == {"byzsgd.step": None, "byzsgd.pull": "byzsgd.step",
                         "byzsgd.grads": "byzsgd.step",
                         "byzsgd.model": "byzsgd.grads",
                         "rwkv6.wkv": "byzsgd.model",
                         "byzsgd.flatten": "byzsgd.grads",
                         "byzsgd.select": "byzsgd.step"}
    assert sp.total_ns("byzsgd.model") == 180
    assert sp.total_ns("byzsgd.grads") == 225
    assert sp.total_ns("byzsgd.step") == 300 == sp.device_ns - 3
    assert sp.idle_ns == {"byzsgd.step": 35 + 306, "byzsgd.pull": 80,
                          "byzsgd.model": 30 + 10 + 40 + 70 + 45,
                          "byzsgd.flatten": 60, "byzsgd.select": 20,
                          spans.OUTSIDE: 1}
    assert sum(sp.idle_ns.values()) == sp.window_ns - sp.busy_ns
    assert sp.calls["rwkv6.wkv"] == 2 and sp.calls["byzsgd.host_sync"] == 1
    assert sp.launches["rwkv6.wkv"] == 3
    num = sp.numbers()
    assert num == pytest.approx({
        "pull_ms_per_step": 25e-6, "attack_ms_per_step": None,
        "select_ms_per_step": 50e-6, "aggregate_ms_per_step": None,
        "update_ms_per_step": None, "gather_ms_per_step": None,
        "model_idle_ms_per_step": 195e-6,
        "protocol_idle_ms_per_step": 160e-6, "host_syncs_per_step": 1.0})
    lines = sp.lines()
    assert any(line.startswith("      rwkv6.wkv") for line in lines)


def test_spans_agree_with_the_ranges_of_the_trace():
    """The model's span reads what the benchmark's range reads; read as
    ranges, the scan takes the node whose number its recompute carried on
    autograd's thread, and a phase that differentiates nothing the node
    whose number its ops carried."""
    events = PROGRAM + OTHER
    sp = spans.reduce(events, steps=1, detail=True)
    tr = trace.reduce(events, ("model", "rwkv6.wkv", "byzsgd.pull"))
    assert tr.range_ns["model"] == sp.total_ns("byzsgd.model") == 180
    assert (tr.range_ns["rwkv6.wkv"], sp.total_ns("rwkv6.wkv")) == (100, 80)
    assert tr.range_ns["byzsgd.pull"] == 25 + 60
    assert spans.diverging(events, sp, "model", "byzsgd.model") == []
    assert spans.diverging(events, sp, "rwkv6.wkv", "rwkv6.wkv") == [
        ["LogsumexpBackward0", "byzsgd.model", pytest.approx(20e-6)]]
    assert spans.diverging(events, sp, "byzsgd.pull", "byzsgd.pull") == [
        ["EmbeddingBackward0", "byzsgd.model", pytest.approx(60e-6)]]
    assert spans.diverging(events, sp, "byzsgd.select", "byzsgd.select") \
        == [[None, "byzsgd.select", pytest.approx(20e-6)]]     # k_gram
    out = spans.checks(sp, tr, trace.reduce(events, spans.PHASES))
    assert out["byzsgd.model"] == out["range model"]
    assert out["idle: model + protocol + outside"] == pytest.approx(
        out["idle"])
    assert out["protocol_ms_per_step (device - range model)"] == \
        pytest.approx(out["phases"] + out["flatten"] + out[
            "rest (step, grads' own, outside)"])


def test_program_spans_leave_the_trace_numbers():
    """The same window with and without the program's spans: every number
    :func:`bench.trace.reduce` gives is the same, but the idle gaps, which
    now name the innermost span where no op was open."""
    ranges = ("model",)
    with_spans = trace.reduce(PROGRAM + OTHER, ranges)
    without = trace.reduce(OTHER, ranges)
    for k in ("window_ns", "busy_ns", "ops_ns", "ops_n", "range_ns"):
        assert getattr(with_spans, k) == getattr(without, k), k
    assert sum(with_spans.gaps_ns.values()) == sum(without.gaps_ns.values())
    assert without.gaps_ns == {"python, in no op": 677,
                               "cuLaunchKernel": 20}
    assert with_spans.gaps_ns == {"byzsgd.step": 35 + 306, "byzsgd.pull": 80,
                                  "byzsgd.model": 30 + 10 + 40 + 70 + 45,
                                  "byzsgd.flatten": 60,
                                  "cuLaunchKernel": 20,
                                  "python, in no op": 1}


@pytest.mark.parametrize("name,nested", [
    ("tiny-dense", {}), ("tiny-rwkv6", {"rwkv6.wkv": "byzsgd.model"})])
def test_spans_of_a_tiny_cell_on_the_cpu(tmp_path, name, nested):
    """One DMC period of the program's steps under the profiler, as a
    traced run takes it: every span opens and nests as the step runs
    them, the scan's in the forward and the recompute, and each pull and
    gather counts one host sync."""
    from torch.profiler import ProfilerActivity, profile

    from bench import inputs, program
    cell = tiny_cell(make_root(tmp_path), name)
    cpu = torch.device("cpu")
    prog = program.Program(cell, 2**31 + 5, cpu)
    feed = inputs.TokenFeed(5, cell.config["vocab_size"], cell.traffic, cpu)
    T, G = cell.traffic["T"], cell.traffic["groups"]
    batches = [feed.next() for _ in range(T)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            for b in batches:
                with torch.profiler.record_function(trace.STEP):
                    prog.step(b)
    sp = spans.reduce(list(prof.profiler.kineto_results.events()), T)
    want = {"byzsgd.step": None, "byzsgd.pull": "byzsgd.step",
            "byzsgd.grads": "byzsgd.step", "byzsgd.model": "byzsgd.grads",
            "byzsgd.flatten": "byzsgd.grads",
            "byzsgd.attack": "byzsgd.step", "byzsgd.select": "byzsgd.step",
            "byzsgd.aggregate": "byzsgd.step",
            "byzsgd.update": "byzsgd.step", "byzsgd.gather": "byzsgd.step"}
    assert sp.parent == {**want, **nested}
    assert sp.calls["byzsgd.step"] == T and sp.calls["byzsgd.gather"] == 1
    assert sp.calls["byzsgd.model"] == sp.calls["byzsgd.flatten"] == G * T
    layers = cell.config["num_hidden_layers"]
    for scan in nested:              # the forward and the recompute
        assert sp.calls[scan] == 2 * layers * G * T
    assert sp.numbers()["host_syncs_per_step"] == (T + 1) / T
    assert sum(sp.idle_ns.values()) == sp.window_ns     # no device here

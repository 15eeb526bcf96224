"""The yardstick's arithmetic on hand-worked shapes: the kernels' work,
roofline bounds, the models' FLOPs, the trace's reduction and the
readers built on them."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench import spec, trace, yardstick as ys
from bench.reference import protocol as ref

from conftest import TINY


def test_kernel_work_by_hand():
    assert ys.visible_pairs(4, 4) == 10
    assert ys.visible_pairs(4, 4, window=2) == 7           # 1 + 2 + 2 + 2
    assert ys.visible_pairs(4, 4, causal=False) == 16
    assert ys.flash_fwd_work(1, 4, 4, 2, 1, 8, 2) == (640.0, 416.0)
    # the backward: 5 products; q, o, do read and dq written (4 x q), k, v
    # read and dk, dv written (4 x kv), the log-sum-exp read
    assert ys.flash_bwd_work(1, 4, 4, 2, 1, 8, 2) == (
        2.0 * 8 * 20 * 5, 4 * 128 + 4 * 64 + 4.0 * 8)
    assert ys.bitonic_ops(4) == 12 and ys.bitonic_ops(3) == 12
    assert ys.median_work(4, 4, 10) == (480.0, 800.0)
    assert ys.gram_work(1, 4, 10) == (200.0, 224.0)
    assert ys.select_work(4, 3, 3, 2) == (48.0, 264.0)
    assert ys.n_subsets(3, 1) == 3
    assert ys.bound_s(ys.PEAK_BF16, 2 * ys.HBM_BPS, ys.PEAK_BF16) == 2.0


def test_model_flops_by_hand():
    dense, rwkv = TINY["tiny-dense"], TINY["tiny-rwkv6"]
    mult = 2 * (128 * 128 + 2 * 128 * 64 + 128 * 128 + 3 * 128 * 256) \
        + 512 * 128
    attn = 12 * 32 * (64 * 65 // 2) * 4 * 2 * 4
    assert ref.family(dense).model_flops(dense, 4, 64) == \
        6 * mult * 4 * 64 + attn
    mult = 2 * (6 * 128 * 128 + 2 * 128 * 256 + 2 * 128 * 64) + 512 * 128
    wkv = 12 * 2 * 64 * 64 * 2
    assert ref.family(rwkv).model_flops(rwkv, 4, 64) == \
        (6 * mult + wkv) * 4 * 64


def _cell(name="phi4-1k"):
    return spec.load_cell(name)


def _run(cell, tr=None, steps=10, seconds=2.0, peak=0):
    return SimpleNamespace(cell=cell, setup_s=12.5, steps=steps,
                           seconds=seconds, memory_peak_bytes=peak, trace=tr)


def test_window_readers():
    cell = _cell()
    run = _run(cell, peak=52_400_000_000)
    tokens = 4 * 4 * 1024
    assert cell.metrics["train_tokens_per_s"].read(run) == tokens * 10 / 2.0
    assert cell.metrics["setup_s"].read(run) == 12.5
    assert cell.layers["peak_mem_gb"].read(run) == 52.4
    flops = 4 * ref.family(cell.config).model_flops(cell.config, 4, 1024)
    assert cell.layers["mfu"].read(run) == pytest.approx(
        100 * flops * 10 / 2.0 / 989e12)
    # ~8.1e13 model FLOPs a step at 4 x 4 x 1024 tokens
    assert 8.0e13 < flops < 8.2e13


def test_roofline_readers():
    cell = _cell()
    P = 815_938_560
    tr = trace.Trace(window_ns=10**9, busy_ns=9 * 10**8, steps=5, gathers=1,
                     range_ns={"model": 3 * 10**8})
    median = 4 * (4 * 4 * P + 4 * P) / ys.HBM_BPS
    gram = 4 * (4 * P + 16) / ys.HBM_BPS
    need = 5 * (median + gram + 264 / ys.HBM_BPS) + median
    tr.ops_ns = {"void (anonymous namespace)::order_stat_kernel<4, 0>(...)":
                 int(2e9 * need * 0.5),
                 "void (anonymous namespace)::gram_reg_kernel<4, 4>(...)":
                 int(2e9 * need * 0.5),
                 "void fwd_kernel<128>(CUtensorMap)": 10**6,
                 "void dq_kernel<128>(CUtensorMap)": 10**6,
                 "void dkv_kernel<128>(CUtensorMap)": 2 * 10**6,
                 "nvjet_tst_64x8": 5 * 10**8}
    # 2 layers x 4 groups x 5 steps, each forward run twice (remat)
    tr.ops_n = {"void fwd_kernel<128>(CUtensorMap)": 80,
                "void dq_kernel<128>(CUtensorMap)": 40,
                "void dkv_kernel<128>(CUtensorMap)": 40}
    run = _run(cell, tr)
    assert cell.layers["agg_roofline"].read(run) == pytest.approx(
        50.0, rel=1e-6)
    shape = (4, 1024, 1024, 24, 8, 128, 2)
    fwd = ys.bound_s(*ys.flash_fwd_work(*shape), ys.PEAK_BF16)
    bwd = ys.bound_s(*ys.flash_bwd_work(*shape), ys.PEAK_BF16)
    assert cell.layers["attn_roofline"].read(run) == pytest.approx(
        100 * (80 * fwd + 40 * bwd) / 4e-3)
    # without the recomputed forward the bound follows the launches
    tr.ops_n["void fwd_kernel<128>(CUtensorMap)"] = 40
    assert cell.layers["attn_roofline"].read(run) == pytest.approx(
        100 * 40 * (fwd + bwd) / 4e-3)
    assert cell.layers["device_idle_pct"].read(run) == pytest.approx(10.0)
    assert cell.layers["protocol_ms_per_step"].read(run) == pytest.approx(
        (tr.device_ns - 3e8) / 5 / 1e6)
    assert "wkv_ms_per_step" not in cell.layers
    rw = _cell("rwkv6-4k")
    assert "attn_roofline" not in rw.layers
    tr.range_ns["wkv"] = 10**9
    assert rw.layers["wkv_ms_per_step"].read(_run(rw, tr)) == 200.0


class _E:
    """A raw profiler record."""

    def __init__(self, name, start, end, *, thread=1, device=False,
                 corr=0, link=0, seq=-1, note=False):
        self._v = dict(name=name, start_ns=start, end_ns=end,
                       duration_ns=end - start, start_thread_id=thread,
                       correlation_id=corr, linked_correlation_id=link,
                       sequence_nr=seq, is_user_annotation=note,
                       device_type=(torch.autograd.DeviceType.CUDA if device
                                    else torch.autograd.DeviceType.CPU))

    def __getattr__(self, k):
        return lambda: self._v[k]


def test_trace_reduction_by_hand():
    events = [
        _E(trace.WINDOW, 0, 1000, corr=1),
        _E("model", 100, 400, corr=2, note=True),
        _E("aten::mm", 150, 200, corr=11, seq=5),
        _E("cudaLaunchKernel", 160, 170, link=21),        # a runtime call
        _E("aten::add", 500, 520, corr=12),
        _E("autograd::engine::evaluate_function: MmBackward0", 600, 700,
           thread=2, corr=13, seq=5),
        _E("aten::mm", 610, 690, thread=2, corr=14),
        _E("k1", 210, 300, device=True, link=11),
        _E("k2", 530, 560, device=True, link=12),
        _E("k3", 700, 800, device=True, link=14),
        _E("model", 100, 400, device=True, note=True),     # its device span
    ]
    tr = trace.reduce(events, ("model",))
    assert (tr.window_ns, tr.busy_ns) == (1000, 220)
    assert tr.ops_ns == {"k1": 90, "k2": 30, "k3": 100}
    assert tr.ops_n == {"k1": 1, "k2": 1, "k3": 1}
    assert tr.range_ns == {"model": 190}
    assert tr.gaps_ns == {"model": 210, "python, in no op": 570}
    assert tr.breakdown(1) == {"device_ops": [["k3", 1e-7]],
                               "idle_gaps": [["python, in no op", 5.7e-7]]}


def test_comparison_numbers_by_hand():
    from bench import compare
    ref = np.array([[2.0, 4.0, 0.001]])          # median leaf 2.0
    assert compare.leaf_gap(ref * [[1.0, 1.01, 1.0]], ref) == \
        pytest.approx(0.01)
    assert compare.leaf_gap(ref + [[0, 0, 0.02]], ref) == pytest.approx(0.01)
    assert compare.leaf_gap(None, ref) == float("inf")
    assert compare.leaf_gap(ref * np.nan, ref) == float("inf")

"""BENCHMARK.json and the files it names: every cell's configuration,
traffic mix, limits and metric readers are found by name; a cell added as
files is taken with no code edit; names, units and keys keep to the
benchmark's contract."""
from __future__ import annotations

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import compare, spec
from bench.reference import protocol as ref

from conftest import TINY, make_root, tiny_cell

DOC = spec.read_json(spec.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in DOC["workloads"]]
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
LINE = re.compile(r"[^\n\t]{1,200}")


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = spec.load_cell(name)
    assert ref.family(cell.config).__name__ == \
        f"bench.reference.{cell.config['model_type']}"
    assert set(cell.limits) >= set(compare.NUMBERS)
    assert "train_tokens_per_s" in cell.metrics and "setup_s" in cell.metrics
    assert cell.layers, "every cell reports a per-layer metric"
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        if name in m.get("workloads", [name]):
            mod = (cell.metrics | cell.layers)[m["name"]]
            assert mod.UNIT == m["unit"]


@pytest.mark.parametrize("name", sorted(TINY))
def test_cell_added_as_files_needs_no_code(tmp_path, name):
    root = make_root(tmp_path, traffic={"seq": 32})
    cell = tiny_cell(root, name)
    assert cell.traffic["seq"] == 32
    assert cell.config["port"]["reduced"]
    assert set(cell.layers) >= {"device_idle_pct", "mfu"}


#: a family added as one new file of ``bench/reference/``: a dense
#: decoder under another ``model_type``, with attention over half the
#: sequence's keys
_FAMILY = """
from bench.reference.phi3 import dims, leaf_table, model_flops, loss


def attention_calls(c, rows, seq):
    return [dict(B=rows, Sq=seq, Skv=seq, H=dims(c)["H"], kvH=dims(c)["kvH"],
                 hd=dims(c)["hd"], window=seq // 2)] * dims(c)["L"]
"""


def test_family_added_as_a_file_needs_no_code(tmp_path, monkeypatch):
    """A configuration of a new ``model_type`` is run by the reference and
    read by the metrics once its family module is added as a file."""
    import bench.reference
    from bench import inputs, trace
    from bench import yardstick as ys
    from types import SimpleNamespace

    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "toy_decoder.py").write_text(_FAMILY)
    monkeypatch.setattr(bench.reference, "__path__",
                        [*bench.reference.__path__, str(pkg)])
    monkeypatch.setitem(TINY, "tiny-toy", {**TINY["tiny-dense"],
                                           "model_type": "toy_decoder"})
    root = make_root(tmp_path / "root", traffic={"seq": 16})
    cell = tiny_cell(root, "tiny-toy")
    fam = ref.family(cell.config)
    assert fam.__name__ == "bench.reference.toy_decoder"
    cpu = torch.device("cpu")
    feed = inputs.TokenFeed(3, 512, cell.traffic, cpu)
    out = ref.run(cell.config, cell.traffic,
                  inputs.make_weights(cell.config, 3, cpu), [feed.next()],
                  inputs.quorum_tables(3, cell.traffic), 1)
    assert np.all(np.isfinite(out["losses"]))
    tr = trace.Trace(window_ns=10**9, busy_ns=10**9, steps=5, gathers=1,
                     ops_ns={"void fwd_kernel<32>(CUtensorMap)": 10**6,
                             "void dq_kernel<32>(CUtensorMap)": 10**6},
                     ops_n={"void fwd_kernel<32>(CUtensorMap)": 40,
                            "void dq_kernel<32>(CUtensorMap)": 40})
    view = SimpleNamespace(cell=cell, steps=5, seconds=1.0, trace=tr)
    shape = dict(B=4, Sq=16, Skv=16, H=4, kvH=2, hd=32, window=8,
                 itemsize=2)
    one = sum(ys.bound_s(*w(**shape), ys.PEAK_BF16)
              for w in (ys.flash_fwd_work, ys.flash_bwd_work))
    assert cell.layers["attn_roofline"].read(view) == pytest.approx(
        100 * one * 2 * 4 * 5 / 2e-3)
    assert cell.layers["mfu"].read(view) > 0


def test_missing_metric_reader_is_refused(tmp_path):
    root = make_root(tmp_path)
    (root / "bench" / "metrics" / "mfu.py").unlink()
    with pytest.raises(FileNotFoundError):
        tiny_cell(root, "tiny-dense")


def test_keys_and_names():
    assert set(DOC) == {"command", "paths", "run_seconds", *KEYS}
    for section, keys in KEYS.items():
        for entry in DOC[section]:
            assert set(entry) - {"workloads"} == keys, entry
            assert spec.NAME.fullmatch(entry["name"]), entry["name"]
            if "unit" in entry:
                assert spec.UNIT.fullmatch(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in entry and section in ("configs", "workloads",
                                              "per_layer"):
                    assert LINE.fullmatch(str(entry[k])), (k, entry[k])
    for section in KEYS:
        names = [e["name"] for e in DOC[section]]
        assert len(set(names)) == len(names)
    for w in DOC["workloads"]:
        assert spec.NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4)
    assert len({(w["config"], w["traffic"]) for w in DOC["workloads"]}) \
        == len(DOC["workloads"])
    for c in DOC["configs"]:
        assert c["reduced"] and all(spec.NAME.fullmatch(k)
                                    for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in DOC["workloads"])


def test_files_stay_under_paths():
    (path,) = DOC["paths"]
    assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path)
    assert DOC["command"][:3] == ["python3", "-m", "bench.run"]
    for c in DOC["configs"]:
        assert Path(c["file"]).parts[0] == path
        assert (spec.ROOT / c["file"]).is_file()
    for f in (spec.ROOT / path).rglob("*"):
        if "__pycache__" not in f.parts:
            rel = str(f.relative_to(spec.ROOT))
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def test_metrics_moves_and_bounds():
    e2e = {m["name"]: m for m in DOC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in DOC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m["workloads"]) <= set(CELLS)
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in CELLS:
        assert any(cell in m["workloads"] for m in DOC["per_layer"])


def test_run_seconds_fit_a_full_check():
    """2 + 14 runs a cell for 24 cells, each allowed run_seconds + 60,
    2 x 90 s a cell to compile and 1200 s spare, within 43200 s."""
    rs = DOC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("name", sorted(TINY) + [c["name"] for c in
                                                  DOC["configs"]])
def test_leaf_layout_is_the_programs(name):
    """The flat layout the benchmark makes its weights in is the one the
    program's parameters flatten to (its leaves in path order)."""
    from bench import program
    cfg = TINY.get(name) or spec.read_json(spec.ROOT / next(
        c["file"] for c in DOC["configs"] if c["name"] == name))
    m = program.port()
    port = cfg["port"]
    bundle = m["get_bundle"](port["arch"], reduced=port.get("reduced", False),
                             depth=port.get("depth"))
    tree = m["FlatTree"].from_params(bundle.meta_params())
    assert [("/".join(p), s) for p, s in zip(tree.paths, tree.shapes)] == [
        (p, tuple(s)) for p, s, _, _ in ref.spans(cfg)]


def test_configs_reduce_depth_only():
    for c in DOC["configs"]:
        cfg = spec.read_json(spec.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"] == ["num_hidden_layers"]
        assert cfg["published"]["num_hidden_layers"] > cfg[
            "num_hidden_layers"]
        assert cfg["source"].startswith(c["source"])
        P = sum(n for *_, n in ref.spans(cfg))
        assert P == {"phi3": 815_938_560, "rwkv6": 338_903_040}[
            cfg["model_type"]]
        assert math.isfinite(P)

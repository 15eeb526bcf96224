"""The benchmark's data, found by the names ``BENCHMARK.json`` gives:

  * a configuration: the ``file`` its ``configs`` entry names (under
    ``bench/configs/``): the model's sizes as run, the port's arch id and
    depth, and what was cut;
  * a traffic mix: ``bench/traffic/<traffic>.json``, the protocol's and
    the batches' parameters;
  * a metric: ``bench/metrics/<name>.py``, a reader with ``UNIT``,
    optionally ``RANGES`` (ranges to name in a traced run), and
    ``read(run)``, which returns the number or ``None`` where the run
    holds nothing to read;
  * a cell's limits: ``bench/limits/<workload>.json``, each number the
    comparison takes with its limit.

Adding a configuration, a mix, a metric or a cell adds files and entries;
no code here names one.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    limits: dict
    metrics: dict = field(default_factory=dict)   # e2e name -> reader
    layers: dict = field(default_factory=dict)    # per-layer name -> reader


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(name: str, bench: Path = BENCH):
    """The module of metric ``name`` (``bench/metrics/<name>.py``)."""
    path = bench / "metrics" / f"{name}.py"
    mod_name = "bench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"metric {name!r}: no reader at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: Path = ROOT, bench: Path = BENCH) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` with every file
    it names read, and the readers of the metrics it reports."""
    spec = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = read_json(root / configs[w["config"]]["file"])
    traffic = read_json(bench / "traffic" / f"{w['traffic']}.json")
    limits = read_json(bench / "limits" / f"{name}.json")

    def mine(metrics):
        return {m["name"]: reader(m["name"], bench) for m in metrics
                if name in m.get("workloads", [name])}

    return Cell(name=name, config=config, traffic=traffic, chips=w["chips"],
                limits=limits, metrics=mine(spec["end_to_end"]),
                layers=mine(spec["per_layer"]))

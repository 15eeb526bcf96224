"""On the card: one short run of each cell through the command, with a
result that is correct and holds the cell's metrics. Run there with
``python -m pytest -m card bench/tests``; it skips itself without a
CUDA card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from bench import spec

CELLS = [w["name"] for w in spec.read_json(spec.ROOT / "BENCHMARK.json")[
    "workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "-m", "bench.run", "--workload",
                        name, "--seed", "2147483711", "--seconds", "2",
                        "--trace", "0"], cwd=spec.ROOT, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["check"]
    assert set(out["metrics"]) == set(spec.load_cell(name).metrics)
    assert out["device"]["platform"] == "gpu"

"""The comparison's own checks: a run on the CPU (past the harness's look
for a card) with the timed path broken underneath comes out not correct,
once for each fault a training cell can have (a step that leaves the
state unchanged, half of each group's batch left out, one leaf's move
altered where it is made, one server's MDA pick altered where it is
made), and so does the control, the program's
replicas one precision below the configuration's (bfloat16 for float32).
A sound run comes out correct. On one card no exchange between chips
exists to leave out.

The faults are held to the real cells' limits; the sound runs to the
tiny models' own (their bf16 rounding is coarser than the full widths'),
written beside them as a cell's limits would be."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from bench import program, run as bench_run, spec

from conftest import TINY, make_root, tiny_cell

CPU = torch.device("cpu")
#: the real cell whose limits each tiny family is held to under a fault
LIMITS = {"tiny-dense": "phi4-1k", "tiny-rwkv6": "rwkv6-4k"}
#: the tiny models' limits for a sound run (their readings on the CPU:
#: loss 4e-5 to 1.5e-4, leaves 1e-3 to 5.7e-2, picks 0 to 2.6e-2)
TINY_LIMITS = {"loss_gap": {"limit": 1e-3}, "grad_gap": {"limit": 0.15},
               "change_gap": {"limit": 0.15}, "select_gap": {"limit": 0.1}}


def _run(root, name, **kw):
    cell = tiny_cell(root, name)
    return bench_run.run(cell, 2**31 + 99, 0.01, False, CPU,
                         log=lambda *a, **k: None, **kw)


@pytest.mark.parametrize("fault", program.FAULTS)
@pytest.mark.parametrize("name", sorted(TINY))
def test_fault_is_not_correct(tmp_path, name, fault):
    root = make_root(tmp_path, limits=LIMITS[name])
    out = _run(root, name, fault=fault)
    assert out["correct"] is False, out["check"]


@pytest.mark.parametrize("name", sorted(TINY))
def test_control_is_not_correct(tmp_path, name, monkeypatch):
    monkeypatch.setitem(TINY[name], "param_dtype", "bfloat16")
    root = make_root(tmp_path, limits=LIMITS[name])
    out = _run(root, name)
    assert out["correct"] is False, out["check"]
    assert out["check"]["grad_gap"]["value"] > 1.0


@pytest.mark.parametrize("name", sorted(TINY))
def test_sound_run_is_correct(tmp_path, name):
    root = make_root(tmp_path)
    (root / "bench" / "limits" / f"{name}.json").write_text(
        json.dumps(TINY_LIMITS))
    out = _run(root, name)
    assert out["correct"] is True, out["check"]
    assert list(out)[-1] == "check"
    assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}


def test_no_card_no_result():
    """Without a CUDA card the command exits 2 and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    p = subprocess.run([sys.executable, "-m", "bench.run", "--workload",
                        "phi4-1k", "--seed", "1", "--seconds", "1"],
                       cwd=spec.ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 2 and p.stdout == "", (p.stdout, p.stderr)


def test_no_program_no_run(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files, the program cannot be loaded and nothing runs."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-c",
                        "from bench import program; program.port()"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and "repro_torch" in p.stderr

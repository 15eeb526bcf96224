"""The port stands alone: nothing under src/repro_torch/, tools/,
chip_smoke.py, tests/_torch_dist_runner.py, tests/_torch_tp_runner.py,
tests/_torch_tp_zoo_runner.py or tests/_torch_mlp_model_runner.py imports jax, any repro.* module (repro_torch.* is allowed) or
the JAX package's benchmarks/ (netsim keeps its own copy of the byte
model), and the chip smoke script refuses to run without a GPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
    (ROOT / "tools").glob("*.py")) + [ROOT / "chip_smoke.py",
                                      ROOT / "tests" / "_torch_dist_runner.py",
                                      ROOT / "tests" / "_torch_tp_runner.py",
                                      ROOT / "tests" /
                                      "_torch_tp_zoo_runner.py",
                                      ROOT / "tests" /
                                      "_torch_mlp_model_runner.py"]


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return (top in ("jax", "jaxlib", "repro", "benchmarks")
            or name.startswith("jax"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _absolute(path: Path, node: ast.ImportFrom) -> str:
    pkg = list(path.relative_to(ROOT / "src").with_suffix("").parts[:-1])
    base = pkg[:len(pkg) - node.level + 1]
    return ".".join(base + ([node.module] if node.module else []))


@pytest.mark.parametrize(
    "path", sorted((ROOT / "src" / "repro_torch" / "kernels").rglob("*.py")),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_kernels_import_nothing_above_them(path):
    """The kernel packages sit at the bottom: models and agg import them,
    never the other way round."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = [_absolute(path, n) if n.level else n.module or ""
             for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    names += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
              for a in n.names]
    bad = [n for n in names if n.startswith("repro_torch")
           and not n.startswith("repro_torch.kernels")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT / "src").as_posix() for p in FILES
             if ROOT / "src" in p.parents}
    for mod in ("repro_torch/models/layers.py", "repro_torch/serve/service.py",
                "repro_torch/models/moe.py", "repro_torch/models/rwkv6.py",
                "repro_torch/kernels/flash_attention/ops.py",
                "repro_torch/kernels/cwise_median/ops.py",
                "repro_torch/kernels/pairwise_sqdist/ops.py",
                "repro_torch/kernels/mda_diameter/ops.py",
                "repro_torch/core/simulator.py", "repro_torch/core/engine.py",
                "repro_torch/core/protocol.py",
                "repro_torch/launch/train.py",
                "repro_torch/launch/mesh.py",
                "repro_torch/launch/steps.py",
                "repro_torch/models/sharding.py",
                "repro_torch/core/compression.py",
                "repro_torch/exp/runners.py",
                "repro_torch/netsim/accounting.py",
                "repro_torch/netsim/cluster.py",
                "repro_torch/netsim/scenarios.py",
                "repro_torch/exp/__main__.py", "repro_torch/agg/__main__.py",
                "repro_torch/serve/__main__.py"):
        assert mod in names
    assert "jax" in {n for n in _imports(
        ROOT / "tests" / "test_torch_serve.py")}  # the scan sees imports


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """Without CUDA the script exits non-zero, names the missing device and
    prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    env = dict(os.environ, PYTHONPATH="")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert "CUDA" in res.stderr + res.stdout
    assert '"ok"' not in res.stdout

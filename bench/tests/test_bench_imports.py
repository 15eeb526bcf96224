"""The import guard: importing and dry-running the harness and the
reference leaves neither JAX nor the JAX package (``repro``) in
``sys.modules``, compared by whole top-level names, since the port's name
``repro_torch`` begins with ``repro``; the reference loads nothing of the
program either."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from bench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in spec.BENCH.rglob("*.py") if "tests" not in p.parts)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_top_level_names_are_compared_whole():
    names = {"repro_torch.core", "repro_torch", "jaxtyping", "reprox"}
    assert {n.split(".")[0] for n in names} & FORBIDDEN == set()
    assert {n.split(".")[0] for n in ("repro.core", "jax.numpy")} \
        & FORBIDDEN == {"repro", "jax"}


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(spec.ROOT)))
def test_sources_import_no_jax(path):
    tops = {n.split(".")[0] for n in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    if path.name != "program.py":
        assert "repro_torch" not in tops, path


_DRY_RUN = """
import sys, torch
sys.path.insert(0, "bench/tests")
from pathlib import Path
from conftest import make_root, tiny_cell
from bench import run, calibrate
from bench.reference import protocol
root = make_root(Path(sys.argv[1]))
cell = tiny_cell(root, "tiny-dense")
{body}
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _modules(tmp_path, body):
    p = subprocess.run([sys.executable, "-c", _DRY_RUN.format(body=body),
                        str(tmp_path)], cwd=spec.ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(eval(p.stdout.strip().splitlines()[-1]))


def test_dry_run_loads_no_jax(tmp_path):
    tops = _modules(tmp_path, "out = run.run(cell, 5, 0.01, True, "
                              "torch.device('cpu'), log=lambda *a, **k: "
                              "None)\nassert out['correct'] in (True, False)")
    assert "repro_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN


def test_reference_loads_nothing_of_the_program(tmp_path):
    body = ("from bench import inputs\n"
            "dev = torch.device('cpu')\n"
            "feed = inputs.TokenFeed(5, 512, cell.traffic, dev)\n"
            "protocol.run(cell.config, cell.traffic, inputs.make_weights("
            "cell.config, 5, dev), [feed.next()], inputs.quorum_tables(5, "
            "cell.traffic), 1)")
    tops = _modules(tmp_path, body)
    assert not tops & (FORBIDDEN | {"repro_torch"}), tops

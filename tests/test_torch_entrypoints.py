"""The port's ``python -m`` entry points against the JAX package's table
functions: ``repro_torch.agg`` (every column but ``backends``, which names
the port's routes), ``repro_torch.exp`` (runners, models and presets, for
the entries the port has) and ``repro_torch.serve``, each run as a
subprocess on the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.agg.registry as jregistry
import repro.exp.presets as jpresets
import repro.serve.quorum as jquorum
import repro_torch.agg as agg
import repro_torch.exp as exp

ROOT = Path(__file__).resolve().parents[1]


def _main(module, *args) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    return res.stdout


def _rows(table: str) -> list[list[str]]:
    return [[c.strip() for c in line.strip("|").split("|")]
            for line in table.strip().splitlines()]


@pytest.mark.parametrize("args", [(), ("18", "2"), ("9", "2"), ("30", "7")])
def test_agg_table_equals_jax_but_backends(args):
    out = _main("repro_torch.agg", *args)
    want = jregistry.markdown_table(*map(int, args))
    assert out.strip() == agg.registry.markdown_table(*map(int, args))
    mine, ref = _rows(out), _rows(want)
    assert len(mine) == len(ref) == 2 + len(agg.names())
    col = ref[0].index("backends")
    for a, b in zip(mine, ref):
        assert a[:col] + a[col + 1:] == b[:col] + b[col + 1:]


def test_agg_backends_name_the_dispatch_routes():
    """``torch`` for every rule; a ``cuda (...)`` route exactly where the
    rule's entry point is a dispatch function that reaches a kernel."""
    for s in agg.specs():
        assert s.backends[0] == "torch"
        on_kernels = s.fn.__module__ == agg.dispatch.__name__
        assert (len(s.backends) == 2) == on_kernels, s.name
        if on_kernels:
            assert s.backends[1].startswith("cuda (")
        assert s.is_sanitizer == jregistry.get(s.name).is_sanitizer


def test_exp_tables_equal_jax_for_the_ports_entries():
    """Runners: the reference's rows, ``elastic`` included, with the same
    deliveries; models: equal; presets: the reference's rows of every
    preset the port registers."""
    out = _main("repro_torch.exp")
    runners, models, presets = out.strip().split("\n\n")
    assert runners == exp.runners_table()
    mine, ref = _rows(runners), _rows(jpresets.runners_table())
    assert "`elastic`" in [r[0] for r in mine]
    assert [r[0] for r in mine] == [r[0] for r in ref]
    assert [r[2] for r in mine] == [r[2] for r in ref]
    assert models == jpresets.models_table()
    names = {f"`{n}`" for n in exp.names()}
    want = [r for r in _rows(jpresets.markdown_table())
            if r[0] in names or not r[0].startswith("`")]
    assert _rows(presets) == want
    assert len(want) == 2 + len(exp.names())


def test_serve_table_equals_jax():
    assert _main("repro_torch.serve").strip() == jquorum.markdown_table()

"""Subprocess body for tests/test_torch_dryrun.py: the reference's cell
builders (``repro.launch.steps.build_cell``) on the 16 x 16 production
mesh of 256 forced host devices (set before jax initialises — hence not
in-process), through ``jax.eval_shape`` only: nothing is compiled. For
each (arch, shape) it writes what a device holds: G, the micro-batch
count, each batch input's and each cache leaf's per-device shard shape,
and the train state's per-device bytes (and before the 'fsdp' split).

    python tests/_torch_cells_runner.py OUT.json ARCH[,ARCH...] SHAPE[,...]
"""
import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"

import json  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.shapes import SHAPES  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402
from repro.launch.steps import build_cell  # noqa: E402
from repro.models.registry import get_bundle  # noqa: E402


def _shard(sds) -> list:
    return list(sds.sharding.shard_shape(sds.shape))


def _bytes(tree) -> int:
    return int(sum(np.prod(_shard(l)) * np.dtype(l.dtype).itemsize
                   for l in jax.tree.leaves(tree)))


def _axes(sds) -> set:
    out = set()
    for e in sds.sharding.spec:
        out.update(e if isinstance(e, tuple) else (e,))
    return out


def _unsplit_fsdp_bytes(tree, K: int) -> int:
    """The per-device bytes before the 'fsdp' split: each leaf's shard
    times K where 'fsdp' splits it."""
    return int(sum(np.prod(_shard(l)) * np.dtype(l.dtype).itemsize
                   * (K if "fsdp" in _axes(l) else 1)
                   for l in jax.tree.leaves(tree)))


def one(arch: str, shape: str, mesh) -> dict:
    ok, why = get_bundle(arch).supports_cell(shape)
    if not ok:
        return {"skipped": why}
    cell = build_cell(arch, SHAPES[shape], mesh)
    kind = cell.meta["kind"]
    out = {"kind": kind}
    if kind == "train":
        state, batch = cell.in_specs
        out.update(G=cell.meta["G"],
                   grad_microbatches=cell.meta["pcfg"].grad_microbatches,
                   batch={k: _shard(v) for k, v in batch.items()},
                   state_bytes=_bytes((state.params, state.opt)),
                   fsdp=dict(zip(cell.mesh.axis_names,
                                 cell.mesh.devices.shape))["fsdp"])
        out["state_bytes_before_fsdp"] = _unsplit_fsdp_bytes(
            (state.params, state.opt), out["fsdp"])
    else:
        params, a, b = cell.in_specs
        batch, caches = (a, b) if kind == "prefill" else (b, a)
        out.update(batch={k: _shard(v) for k, v in batch.items()},
                   caches=[_shard(l) for l in jax.tree.leaves(caches)],
                   cache_shapes=[list(l.shape)
                                 for l in jax.tree.leaves(caches)])
    return out


def main():
    path, archs, shapes = sys.argv[1], sys.argv[2], sys.argv[3]
    mesh = make_production_mesh()
    res = {f"{a}|{s}": one(a, s, mesh)
           for a in archs.split(",") for s in shapes.split(",")}
    with open(path, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main()

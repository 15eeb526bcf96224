"""Dry run of every (arch x shape x mesh) cell on the production mesh, on
``meta`` tensors — the port of ``repro.launch.dryrun``.

For each cell one rank's step (``launch/steps.py``'s builders) runs once at
full depth on meta tensors, on a :class:`~repro_torch.launch.mesh.RankView`
of the 16 x 16 (or 2 x 16 x 16) mesh: nothing is allocated and no GPU is
needed. The routes are the card's: a meta tensor takes every kernel
(:func:`repro_torch.device.card_route`), and each kernel wrapper answers
with its outputs' shapes and its own count of work
(:mod:`repro_torch.kernels.work`). One dispatch mode, :class:`StepCounter`,
measures the step:

  * ``flops``: torch's ``FlopCounterMode`` formulas (matmuls, attention,
    convolutions) for each aten op, plus each kernel's own count of
    operations; elementwise work has no formula and counts as bytes only;
  * ``bytes_accessed``: each aten op's inputs read and outputs written
    (views move nothing), which is what eager PyTorch moves, plus each
    kernel's own count;
  * ``collective_bytes_per_device`` / ``_counts`` / ``_by_kind``: the
    bytes this rank's collectives send, by tag, as the rank view counts
    them (``Mesh.sent``);
  * ``memory`` in the reference's keys: ``argument_bytes`` (the inputs'
    storages), ``output_bytes`` and ``alias_bytes`` (outputs, and those of
    them that alias an argument: the protocol updates its state in place),
    ``temp_bytes`` and ``peak_bytes`` — the live bytes tracked per new
    output storage (a meta tensor has no address), freed when its storage
    dies; views and in-place results are not counted again.

The cell is reckoned for the fullest rank: the one holding the largest
block of the flat state (``protocol.state_layout``'s 'fsdp' ranges).
The reference's depth probes and ``hlo_analysis.extrapolate`` are not
ported: the port's layers are Python loops, so one full-depth run counts
every layer. Artifacts go under ``results/dryrun_torch/<mesh>/`` in the
reference's layout, read by ``launch/roofline.py``.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dbrx-132b \\
      --shape train_4k --engine naive
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs.shapes import SHAPE_ORDER, SHAPES
from ..core import protocol
from ..kernels import work
from ..models.registry import ARCH_IDS, get_bundle
from .mesh import production_view
from .steps import build_cell, build_gather_cell

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

_aten = torch.ops.aten
# ops that read and write nothing (allocation, metadata)
_NO_BYTES = {_aten.empty, _aten.empty_strided, _aten.empty_like,
             _aten.new_empty, _aten.new_empty_strided, _aten.lift_fresh,
             _aten.detach, _aten.alias, _aten._local_scalar_dense}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _flat(x) -> list:
    """The tensors of an aten op's arguments or results (tensors, and
    lists or tuples of them)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)) or type(x).__name__ == "dict_values":
        return [t for v in x for t in _flat(v)]
    return []


def tensors(obj):
    """Every tensor held in ``obj``: nested dicts, lists, tuples (named
    too), dataclasses, and objects that keep a tensor ``block`` (a ZeRO
    leaf of ``launch/serve.py``)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from tensors(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from tensors(getattr(obj, f.name))
    elif isinstance(getattr(obj, "block", None), torch.Tensor):
        yield obj.block


def _storages(ts) -> dict:
    """Storage key -> bytes of the distinct storages under ``ts``."""
    out = {}
    for t in ts:
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


class StepCounter(TorchDispatchMode):
    """Counts a step's work and live bytes (module docstring) while it is
    active; also a counter of :mod:`repro_torch.kernels.work`, so the
    kernel wrappers report to it, and an aten op inside a wrapper's plain
    version (``hidden``) is not counted again."""

    def __init__(self, args=()):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.n_ops = 0
        self.hidden = 0
        self.kernels: dict = {}
        self.args = _storages(tensors(args))
        self._live: dict = {}
        self.live = 0
        self.peak = 0

    # -- the kernels' reports --------------------------------------------
    def kernel(self, name: str, ops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "ops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["ops"] += ops
        k["bytes"] += nbytes
        self.flops += ops
        self.bytes += nbytes

    # -- aten ops ----------------------------------------------------------
    def _free(self, key) -> None:
        self.live -= self._live.pop(key, 0)

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or key in self.args:
                continue
            self._live[key] = st.nbytes()
            self.live += self._live[key]
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.n_ops += 1
        outs = _flat(out)
        if not self.hidden:
            packet = func.overloadpacket
            count = flop_registry.get(packet)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
            if not (func.is_view or packet in _NO_BYTES):
                self.bytes += sum(_nbytes(t) for t in
                                  _flat(args) + _flat(kwargs.values())
                                  + outs)
        self._track(outs)
        return out


def measure(fn, args, mesh=None) -> tuple[dict, object]:
    """Run ``fn(*args)`` once under a :class:`StepCounter` (and as the
    kernels' work counter); return its figures — ``flops``,
    ``bytes_accessed``, ``collective_*`` from ``mesh.sent`` (the bytes sent
    inside the call), ``memory``, the kernels' counts — and its result.
    The same on meta and on real tensors (``chip_smoke.py`` phase 18
    holds one against the other on the card)."""
    sent0 = collections.Counter(getattr(mesh, "sent", {}))
    calls0 = collections.Counter(getattr(mesh, "calls", {}))
    t0 = time.perf_counter()
    counter = StepCounter(args)
    with work.active(counter), counter:
        out = fn(*args)
    wall = time.perf_counter() - t0
    outs = _storages(tensors(out))
    alias = sum(b for k, b in outs.items() if k in counter.args)
    new_out = sum(b for k, b in outs.items() if k not in counter.args)
    arg = sum(counter.args.values())
    sent = (collections.Counter(getattr(mesh, "sent", {})) - sent0)
    calls = (collections.Counter(getattr(mesh, "calls", {})) - calls0)
    return {
        "wall_s": round(wall, 3),
        "aten_ops": counter.n_ops,
        "flops": counter.flops,
        "bytes_accessed": counter.bytes,
        "kernels": counter.kernels,
        "collective_bytes_per_device": float(sum(sent.values())),
        "collective_counts": dict(calls),
        "collective_bytes_by_kind": {k: float(v) for k, v in sent.items()},
        "memory": {
            "argument_bytes": arg,
            "output_bytes": alias + new_out,
            "temp_bytes": counter.peak - new_out,
            "alias_bytes": alias,
            "peak_bytes": arg + counter.peak,
        },
    }, out


def fullest_rank(arch: str, shape_name: str, *, multi_pod: bool = False,
                 reduced: bool = False) -> int:
    """The production rank holding the largest block: for a train cell the
    'fsdp' coordinate of the largest column range of the flat state
    (coordinate 0 on 'rep' and 'model'); rank 0 for a serving cell (every
    rank's blocks are equal)."""
    cell = SHAPES[shape_name]
    if cell.kind != "train":
        return 0
    probe = build_gather_cell(arch, cell, production_view(multi_pod=multi_pod),
                              reduced=reduced)
    state = probe.in_specs[0]
    P = state.split.local.size if state.split else state.tree.size
    _, _, bounds = protocol.state_layout(probe.mesh, probe.meta["G"], P)
    k = max(range(len(bounds) - 1), key=lambda i: bounds[i + 1] - bounds[i])
    return k * probe.mesh.size("model")


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, engine: str,
             include_gather: bool, exchange_dtype: str = "float32",
             pull: str = "median", reduced: bool = False) -> dict:
    """One cell's artifact (``reduced``: the arch's smoke-test sibling on
    the same mesh, for tests)."""
    cell_cfg = SHAPES[shape_name]
    bundle = get_bundle(arch, reduced=reduced)
    ok, why = bundle.supports_cell(shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}
    rank = fullest_rank(arch, shape_name, multi_pod=multi_pod,
                        reduced=reduced)
    mesh = production_view(multi_pod=multi_pod, rank=rank)
    kw = dict(reduced=reduced)
    if cell_cfg.kind == "train":
        kw.update(engine=engine, exchange_dtype=exchange_dtype, pull=pull)
    out = {"arch": arch, "shape": shape_name, "kind": cell_cfg.kind,
           "mesh": "2x16x16" if multi_pod else "16x16", "engine": engine,
           "n_devices": mesh.n_ranks, "rank": rank,
           "layers": bundle.cfg.n_layers}
    cell = build_cell(arch, cell_cfg, mesh, **kw)
    out["full"], _ = measure(cell.fn, cell.in_specs, cell.mesh)
    if cell_cfg.kind == "train":
        out["n_groups"] = cell.meta["G"]
        out["grad_microbatches"] = cell.meta["pcfg"].grad_microbatches
        out["byz_mesh"] = cell.mesh.sizes
    # one full-depth run counts every layer: nothing to extrapolate
    out["extrapolated"] = {k: out["full"][k] for k in (
        "flops", "bytes_accessed", "collective_bytes_per_device")}
    if cell_cfg.kind == "train" and include_gather:
        gcell = build_gather_cell(arch, cell_cfg, mesh, engine=engine,
                                  reduced=reduced)
        out["gather"], _ = measure(gcell.fn, gcell.in_specs, gcell.mesh)
    return out


def per_device_bytes(mem: dict) -> int:
    return (mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"]
            - mem["alias_bytes"])


def result_path(arch, shape, multi_pod, engine, tag="", results_dir=None):
    d = os.path.join(results_dir or RESULTS_DIR,
                     "2x16x16" if multi_pod else "16x16")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"{arch}__{shape}__{engine}{tag}.json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--engine", default="naive", choices=["naive", "sharded"])
    ap.add_argument("--exchange-dtype", default="float32")
    ap.add_argument("--pull", default="median",
                    choices=["median", "roundrobin"])
    ap.add_argument("--gather", action="store_true", default=True)
    ap.add_argument("--no-gather", dest="gather", action="store_false")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="the archs' smoke-test siblings (artifacts tagged "
                         "__reduced)")
    ap.add_argument("--results-dir", default=None,
                    help=f"default: {os.path.normpath(RESULTS_DIR)}")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = SHAPE_ORDER if args.shape == "all" else args.shape.split(",")

    n_ok = n_skip = n_fail = 0
    t_all = time.time()
    for arch in archs:
        for shape in shapes:
            tag = ""
            if args.pull != "median":
                tag += f"__{args.pull}"
            if args.exchange_dtype != "float32":
                tag += f"__{args.exchange_dtype}"
            if args.reduced:
                tag += "__reduced"
            path = result_path(arch, shape, args.multi_pod, args.engine, tag,
                               args.results_dir)
            if os.path.exists(path) and not args.force:
                print(f"[cached] {arch} x {shape}")
                n_ok += 1
                continue
            t0 = time.time()
            try:
                res = run_cell(arch, shape, multi_pod=args.multi_pod,
                               engine=args.engine,
                               include_gather=args.gather,
                               exchange_dtype=args.exchange_dtype,
                               pull=args.pull, reduced=args.reduced)
            except Exception as e:  # noqa: BLE001 - report and continue
                res = {"arch": arch, "shape": shape, "error": str(e),
                       "traceback": traceback.format_exc()}
                n_fail += 1
                print(f"[FAIL]   {arch} x {shape}: {e}")
                with open(path + ".err", "w") as f:
                    json.dump(res, f, indent=1)
                continue
            res["host_s"] = round(time.time() - t0, 2)
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            if "skipped" in res:
                n_skip += 1
                print(f"[skip]   {arch} x {shape}: {res['skipped']}")
            else:
                n_ok += 1
                per_dev = per_device_bytes(res["full"]["memory"])
                ex = res["extrapolated"]
                print(f"[ok]     {arch} x {shape} ({res['mesh']}, "
                      f"{args.engine}, rank {res['rank']}): "
                      f"flops={ex['flops']:.3e} "
                      f"bytes={ex['bytes_accessed']:.3e} "
                      f"coll={ex['collective_bytes_per_device']:.3e}B "
                      f"mem/dev={per_dev / 2**30:.2f}GiB "
                      f"({res['host_s']:.0f}s)", flush=True)
    print(f"\ndone: {n_ok} ok, {n_skip} skipped, {n_fail} failed "
          f"({time.time() - t_all:.0f} s)")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

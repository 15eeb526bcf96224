"""Byzantine-aware checkpointing — the port of ``repro.checkpoint``.

The JAX package's format, read and written with numpy only:

  * one ``.npy`` per leaf, named by the leaf's JAX tree path with ``/`` ->
    ``__`` (a ``ByzState``'s fields are attributes, so its names carry a
    leading dot: ``.params/w0`` -> ``.params__w0.npy``, ``.t``, ``.key``);
  * ``manifest.json`` with ``step``, ``leaves`` (file, dtype, shape) and
    an optional ``meta`` dict;
  * a write goes to ``<dir>.tmp`` and is renamed into place, and leftover
    ``.tmp`` directories of killed saves are removed, so an interrupted
    save never shadows the last good checkpoint.

bfloat16 leaves are written as JAX writes them (the bits under the ``.npy``
descr ``<V2``, ``"bfloat16"`` in the manifest) and read back by their bits.

A tree is a nested dict of tensors (names are its keys joined by ``/``,
in sorted order, as JAX flattens a dict) or a protocol
:class:`~repro_torch.core.protocol.ByzState`, whose ``[G, P]`` stack is
saved leaf by leaf under the JAX ``ByzState``'s names (plus the port's own
``.gen``, the generator state, which a JAX restore ignores).
``restore_consolidated`` collapses the replica axis with the coordinate-wise
median — the checkpoint-level analogue of DMC: a corrupted replica in the
checkpoint is outvoted.

A ``ByzState`` spread over the ranks of a mesh is saved by every rank: the
stacks are gathered whole (over 'rep', 'fsdp' and 'model', the 'model'
blocks joined leaf by leaf), rank 0 writes the same replica-stacked files
as one card does, and all ranks meet at a barrier. On a mesh that leaves
ranks idle (an elastic run's segment, ``launch.mesh.make_segment_mesh``)
the mesh's ranks do that and meet at a barrier of their own, and a save
on an idle rank returns at once. ``restore`` into a ``like`` with a mesh
(and, with a 'model' axis, its ``split``) reads the files on every rank
and keeps its rows, blocks and columns; an idle rank keeps the step
counter, AdamW's count and the generator's state, and no block.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from .. import agg
from ..core import protocol
from ..device import resolve


def _leaf_paths(tree) -> list[tuple[str, object]]:
    if isinstance(tree, protocol.ByzState):
        return protocol.checkpoint_leaves(tree)
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (str(k),))
        else:
            out.append(("/".join(path), t))

    walk(tree, ())
    return out


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to save, manifest dtype) of a tensor, numpy array or number;
    bfloat16 as its bits (int16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    """``np.save``, but a bfloat16 leaf's bits go under the descr ``<V2``
    that numpy writes for an ``ml_dtypes`` bfloat16 array (the JAX
    checkpoint's file, byte for byte)."""
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as fh:
        np.lib.format.write_array_header_1_0(
            fh, {"descr": "<V2", "fortran_order": False,
                 "shape": arr.shape})
        fh.write(np.ascontiguousarray(arr).tobytes())


def _load(d: str, info: dict) -> torch.Tensor:
    """One leaf as a host tensor (bfloat16 read by its bits)."""
    arr = np.load(os.path.join(d, info["file"]))
    if info["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def step_dir(ckpt_dir: str, step: int) -> str:
    """Canonical directory of one checkpoint step."""
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _parse_step(entry: str) -> int | None:
    """``step_NNNNNNNN`` -> N; anything else (stray files, ``.tmp``
    leftovers, malformed names) -> None."""
    if not entry.startswith("step_") or entry.endswith(".tmp"):
        return None
    suffix = entry[len("step_"):]
    if not suffix.isdigit():
        return None
    return int(suffix)


def _gc_orphan_tmp(ckpt_dir: str) -> None:
    """Remove ``step_*.tmp`` leftovers from killed saves."""
    for entry in os.listdir(ckpt_dir):
        if entry.startswith("step_") and entry.endswith(".tmp"):
            path = os.path.join(ckpt_dir, entry)
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)


def save(ckpt_dir: str, step: int, state, *, meta: dict | None = None) -> str:
    """Atomically save ``state`` (a nested dict of tensors or a
    ``ByzState``) as step ``step``. Returns the final directory. ``meta``
    is a JSON-compatible dict stored verbatim in the manifest (the elastic
    runner records the active groups there)."""
    final = step_dir(ckpt_dir, step)
    mesh = state.mesh if isinstance(state, protocol.ByzState) else None
    if mesh is not None and mesh.n_ranks > 1:
        if not mesh.member:
            return final          # sits the mesh out: its ranks write
        leaves = _leaf_paths(state)    # the gathers: every mesh rank
        if mesh.rank == 0:
            _write(ckpt_dir, final, step, leaves, meta)
        mesh.barrier()
        return final
    return _write(ckpt_dir, final, step, _leaf_paths(state), meta)


def _write(ckpt_dir: str, final: str, step: int, leaves, meta) -> str:
    tmp = final + ".tmp"
    os.makedirs(ckpt_dir, exist_ok=True)
    _gc_orphan_tmp(ckpt_dir)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    if meta is not None:
        manifest["meta"] = meta
    for name, leaf in leaves:
        arr, dtype = _to_numpy(leaf)
        fname = name.replace("/", "__") + ".npy"
        _save_leaf(os.path.join(tmp, fname), arr, dtype)
        manifest["leaves"][name] = {"file": fname, "dtype": dtype,
                                    "shape": list(arr.shape)}
        del arr
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """The highest complete step under ``ckpt_dir`` (a step directory
    without its manifest is an interrupted write and does not count)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for entry in os.listdir(ckpt_dir):
        step = _parse_step(entry)
        if step is None or not os.path.isdir(os.path.join(ckpt_dir, entry)):
            continue
        if not os.path.exists(os.path.join(ckpt_dir, entry, "manifest.json")):
            continue
        steps.append(step)
    return max(steps) if steps else None


def read_manifest(ckpt_dir: str, step: int) -> dict:
    """The manifest dict of one step (leaf shapes and dtypes, and any
    ``meta`` the saver attached); no array is read."""
    with open(os.path.join(step_dir(ckpt_dir, step), "manifest.json")) as f:
        return json.load(f)


def restore(ckpt_dir: str, step: int, like, device=None, *,
            params_only: bool = False):
    """Restore step ``step`` into the structure of ``like`` on ``device``
    (the GPU unless ``"cpu"`` is asked); returns ``(state, step)``.

    ``like`` is a nested dict (its keys name the leaves; other leaves of
    the checkpoint are ignored) or a ``ByzState`` (its ``tree`` names the
    params; see :func:`repro_torch.core.protocol.state_from_leaves`, which
    ``params_only`` is passed to; with its ``mesh`` the state is this
    rank's block). The stored shapes must match."""
    dev = resolve(device)
    d = step_dir(ckpt_dir, step)
    manifest = read_manifest(ckpt_dir, step)
    leaves = manifest["leaves"]

    def read(name):
        return _load(d, leaves[name])

    if isinstance(like, protocol.ByzState):
        state = protocol.state_from_leaves(read, leaves, dev, tree=like.tree,
                                           params_only=params_only)
        return (protocol.shard_state(state, like.mesh, like.split),
                manifest["step"])

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (str(k),)) for k, v in t.items()}
        name = "/".join(path)
        if name not in leaves:
            raise KeyError(f"checkpoint step {step} has no leaf {name!r}")
        return read(name).to(dev)

    return walk(like, ()), manifest["step"]


def _collapse(x: torch.Tensor, replica_axis: int) -> torch.Tensor:
    """Coordinate-wise median over ``replica_axis`` in float32, cast back
    (the median kernel on a CUDA tensor)."""
    x = x.movedim(replica_axis, 0)
    med = agg.dispatch.cwise_median(x.reshape(x.shape[0], -1).float())
    return med.reshape(x.shape[1:]).to(x.dtype)


def restore_consolidated(ckpt_dir: str, step: int, like, device=None, *,
                         replica_axis: int = 0):
    """Median-of-replicas restore: every leaf with a replica axis collapses
    to its coordinate-wise median, so a corrupted replica in the checkpoint
    is outvoted. For a nested-dict ``like`` returns the dict of collapsed
    leaves (scalars pass through); for a ``ByzState`` ``like``, the state
    with ``params`` collapsed to one ``[P]`` model (``tree.unflatten`` names
    it) — a serving model, so neither the optimizer state nor the random
    stream is carried — streamed by column chunks."""
    if isinstance(like, protocol.ByzState):
        state, s = restore(ckpt_dir, step, like, device, params_only=True)
        return state._replace(params=protocol.consolidate(state.params)), s
    tree, s = restore(ckpt_dir, step, like, device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return _collapse(t, replica_axis) if t.ndim > replica_axis else t

    return walk(tree), s

"""The comparison that decides ``correct``: the program's first steps
against the plain reference's on the same inputs.

Four numbers, each with its limit from the cell's limits file:

  * ``loss_gap``: the largest relative gap between a group's loss at a
    checked step in the program and in the reference, over the first
    ``steps`` checked steps where the cell's limit gives them (at phi4's
    full width each step amplifies the bf16 program's departure from the
    float32 reference some thirty-fold, so the later gaps swing from seed
    to seed);
  * ``grad_gap``: the first step's aggregated gradient, as each replica's
    optimizer took it (its move over the learning rate), leaf by leaf: the
    largest gap between the program's norm of a leaf and the reference's,
    over the reference's norm of that leaf or of the replica's median
    leaf, whichever is larger;
  * ``change_gap``: the same of each replica's change over the checked
    steps (the last of them ends in the DMC gather), leaving out the
    leaves whose reference first gradient is under :data:`QUIET` of the
    median leaf's;
  * ``select_gap``: the largest relative gap by which the diameter of a
    subset MDA picked in the program, in the reference's own distances,
    lies above the least diameter of its quorum, over the first ``steps``
    checked steps where the cell's limit gives them (the reference
    follows the program's picks; see :mod:`bench.reference.protocol`).

A number that cannot be read (a missing or non-finite reading) is
infinite, and fails. A number whose limit is ``null`` has no reading
that a fault or the control gives above it, and is not compared.
"""
from __future__ import annotations

import numpy as np

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "select_gap")
QUIET = 1e-3


def leaf_gap(prog: np.ndarray, ref: np.ndarray, keep=None) -> float:
    """The largest ``|prog - ref| / max(ref, median leaf of ref)`` over the
    ``[replicas, leaves]`` readings (``keep``: a mask of those counted)."""
    if prog is None or prog.shape != ref.shape or not np.all(
            np.isfinite(prog)):
        return float("inf")
    den = np.maximum(ref, np.median(ref, axis=1, keepdims=True))
    gap = np.abs(prog - ref) / den
    if keep is not None:
        gap = np.where(keep, gap, 0.0)
    return float(gap.max())


def gaps(prog: dict, ref: dict, limits: dict) -> dict:
    """The four numbers of the program's readings ``prog`` against the
    reference's ``ref`` (each: ``losses [steps, G]``, ``first`` and
    ``change`` ``[G, leaves]``; the reference's ``select_gaps`` a step),
    the loss and the picks over the steps the cell's ``limits`` give
    them."""
    n = limits["loss_gap"].get("steps")
    lp, lr = prog["losses"][:n], ref["losses"][:n]
    loss = (float(np.max(np.abs(lp - lr) / np.abs(lr)))
            if lp.shape == lr.shape and np.all(np.isfinite(lp))
            else float("inf"))
    first = ref["first"]
    keep = first >= QUIET * np.median(first, axis=1, keepdims=True)
    return {"loss_gap": loss,
            "grad_gap": leaf_gap(prog["first"], first),
            "change_gap": leaf_gap(prog["change"], ref["change"], keep),
            "select_gap": float(max(
                ref["select_gaps"][:limits["select_gap"].get("steps")]))}


def compared(limits: dict) -> list[str]:
    return [k for k in NUMBERS if limits[k]["limit"] is not None]


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k]["limit"] for k in compared(limits))


def lines(numbers: dict, limits: dict) -> list[str]:
    """Each number compared beside its limit, one line each."""
    return [f"check {k} {numbers[k]!r} limit {limits[k]['limit']!r}"
            for k in compared(limits)]

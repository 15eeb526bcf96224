"""The kernels' own counts of their work, and the counters they report to.

Each kernel package has one function per kernel that counts the work of a
call from its shapes: the operations it does (multiply-adds as two, a
compare-exchange as two) and the bytes it must move, each input read once
and each output written once (the floor under the card's time; the
bound column of ``chip_smoke.py`` reads the same functions). Each wrapper
reports that count, by :func:`report`, to every counter that is active:

  * on a CUDA tensor where it launches its kernel;
  * on a ``meta`` tensor (the dry run), where it returns empty outputs of
    the launch's shapes and never reaches the plain version or ``ctypes``;
  * on a CPU tensor while a counter is active, where it runs its plain
    version inside :func:`plain_version`, so that the counter skips the
    plain version's own operations: a CPU step is counted as the card's.

A counter is any object with a ``kernel(name, ops, nbytes)`` method and a
``hidden`` int (the depth of plain versions it is inside); the dry run's
step counter (:class:`repro_torch.launch.dryrun.StepCounter`) is one.
Nothing here runs while no counter is active.
"""
from __future__ import annotations

from contextlib import contextmanager

_COUNTERS: list = []


def counting() -> bool:
    """True while a counter is active: the routes follow the card's."""
    return bool(_COUNTERS)


def report(name: str, ops: float, nbytes: float) -> None:
    """One call of kernel ``name`` doing ``ops`` operations and moving
    ``nbytes`` bytes, to every active counter."""
    for c in _COUNTERS:
        c.kernel(name, float(ops), float(nbytes))


@contextmanager
def plain_version():
    """Around a wrapper's plain version while counting: its operations are
    the kernel's, already reported."""
    for c in _COUNTERS:
        c.hidden += 1
    try:
        yield
    finally:
        for c in _COUNTERS:
            c.hidden -= 1


@contextmanager
def active(counter):
    """Make ``counter`` receive the kernels' reports inside the block."""
    _COUNTERS.append(counter)
    try:
        yield counter
    finally:
        _COUNTERS.remove(counter)

"""The rule of the port's spans and marks (re-exported by
:mod:`repro_torch.spans`, which lists the names): it sits below the kernel
packages so that they open their spans by it, as they import nothing of
the port above them.

``span(name)`` opens ``torch.profiler.record_function(name)`` while the
profiler records, else it is one check of the profiler's own flag;
``mark(name)`` records one zero-length range under the same rule.
"""
from __future__ import annotations

from contextlib import nullcontext

from torch.autograd import profiler as _profiler

_OFF = nullcontext()


def span(name: str):
    """A range named ``name`` while the profiler records, else a no-op."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF


def mark(name: str) -> None:
    """One zero-length range named ``name`` while the profiler records."""
    if _profiler._is_profiler_enabled:
        with _profiler.record_function(name):
            pass

"""Named spans and marks of the port's own work, on the profiler's clock.

``span(name)`` is a context manager: while ``torch.profiler`` records, it
opens ``torch.profiler.record_function(name)``, so the span lands in the
same Kineto trace as the device's records and shares its clock; the
profiler propagates the range to autograd's threads, so a span opened in a
rematerialized block's recompute is recorded there too. ``mark(name)``
records one zero-length range, a count the trace holds. With the profiler
off each call is one check of the profiler's own flag and records nothing.

The names the port emits (each protocol phase that exchanges data takes
the ``Mesh.sent`` tag of its bytes):

  * ``byzsgd.step``: the train step (scatter, then the DMC gather);
  * ``byzsgd.pull``: the delivery draw, the masks and the masked pull;
  * ``byzsgd.grads``: the per-group gradients, holding per group
    ``byzsgd.model`` (the loss and its backward) and ``byzsgd.flatten``
    (the per-leaf copies into the flat gradient stack);
  * ``byzsgd.attack``, ``byzsgd.select`` (push quorums, Gram, squared
    distances, MDA's weights), ``byzsgd.aggregate``, ``byzsgd.update``,
    ``byzsgd.gather`` (the DMC gather);
  * ``rwkv6.wkv`` and ``mamba2.ssd``: the chunked scans, forward and
    recompute;
  * the mark ``byzsgd.host_sync``: a device-to-host read inside the step.
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

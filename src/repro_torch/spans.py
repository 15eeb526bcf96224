"""Named spans and marks of the port's own work, on the profiler's clock.

``span(name)`` is a context manager: while ``torch.profiler`` records, it
opens ``torch.profiler.record_function(name)``, so the span lands in the
same Kineto trace as the device's records and shares its clock; the
profiler propagates the range to autograd's threads, so a span opened in a
rematerialized block's recompute is recorded there too. ``mark(name)``
records one zero-length range, a count the trace holds. With the profiler
off each call is one check of the profiler's own flag and records nothing.
The rule lives in :mod:`repro_torch.kernels._spans`, below the kernel
packages, which open their spans by it.

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
  * ``rwkv6.wkv_state``: each launch of the WKV scan's chunk-recurrence
    kernels, forward (inside ``rwkv6.wkv``) and backward
    (``repro_torch.kernels.wkv_scan.ops``);
  * the mark ``byzsgd.host_sync``: a device-to-host read inside the step.
"""
from __future__ import annotations

from .kernels._spans import mark, span

__all__ = ["mark", "span"]

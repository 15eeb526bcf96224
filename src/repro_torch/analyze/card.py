"""Layer 3 — the engines on the card (``python -m repro_torch.analyze
--card``), in place of the reference's REPRO-HLO-HOST-TRANSFER.

* **REPRO-CARD-HOST-TRANSFER** — ``EpochEngine.run`` and
  ``ProtocolEngine.run`` promise ONE device->host copy per run (the metric
  buffers, read once at the end). On the ``smoke`` preset, for the fused
  engine and both collective engines of the protocol:

  - one ``run()`` is profiled (``torch.profiler``) and its ``Memcpy DtoH``
    records counted: exactly one is allowed;
  - one ``run_epoch`` runs under ``torch.cuda.set_sync_debug_mode("error")``
    and must not raise (the reference's
    ``transfer_guard_device_to_host("disallow")``).

  :func:`measure` also counts, in ``"warn"`` mode, the syncs of one
  ``run_epoch`` per step and of one serve decode step per token — the
  numbers ``chip_smoke.py`` phase 19 prints as ``[analyze-card]`` lines.

``set_sync_debug_mode`` sees CUDA syncs only, so this layer means nothing
on the CPU: it raises without a CUDA device, and neither skips nor falls
back. Not ported: REPRO-HLO-RECOMPILE and the HLO-text audits — the port
compiles no artifact and keeps no compile cache (``core/epochs.py`` and
``launch/hlo_analysis.py`` are not ported).
"""
from __future__ import annotations

from .findings import Finding
from .registry import Rule, register
from .run import ENGINE, PROTOCOL, epoch_buffers, fused_engine, \
    protocol_engine, serve_service

#: steps of the profiled run and of the guarded epoch (cross T = 5)
STEPS = 6


def _require_card(device):
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("repro_torch.analyze --card needs a CUDA device: "
                           "set_sync_debug_mode sees CUDA syncs only")
    return torch.device(device)


def _dtoh(fn) -> int:
    """Device->host copies recorded by the profiler over one call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if "Memcpy DtoH" in e.key)


def _site(w) -> str:
    """A sync warning's Python line, relative to the package."""
    import os
    path = w.filename.replace(os.sep, "/")
    cut = path.rfind("/repro_torch/")
    return f"{path[cut + 1:] if cut >= 0 else path}:{w.lineno}"


def _syncs(fn, guard: bool = True) -> tuple[dict, str | None]:
    """(the syncs of one call counted in "warn" mode, by the Python line
    that made them; with ``guard``, the message "error" mode raises with
    on a second call, or None)."""
    import collections
    import warnings

    import torch
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(_site(w) for w in got
                                if "synchroniz" in str(w.message))
    if not guard:
        return dict(sites), None
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        err = None
    except RuntimeError as e:
        err = str(e).splitlines()[0][:200]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return dict(sites), err


def measure(device="cuda") -> dict:
    """Per engine: ``dtoh_per_run``, ``syncs_per_step`` (warn mode), the
    ``sync_sites`` (``path:line`` -> syncs over one epoch) and
    ``epoch_error`` (the "error" mode's message, or None); for serving:
    ``syncs_per_decode_step``, ``syncs_per_token`` and ``sync_sites``."""
    import torch
    dev = _require_card(device)
    out = {}
    builds = [("fused", lambda: fused_engine(dev))]
    builds += [(f"protocol[{e}]", lambda e=e: protocol_engine(e, dev))
               for e in ("naive", "sharded")]
    for label, build in builds:
        _, eng, state, stream = build()
        eng.run(state, stream=stream, steps=STEPS)            # warm
        _, eng, state, stream = build()
        n = _dtoh(lambda: eng.run(state, stream=stream, steps=STEPS,
                                  epoch_steps=STEPS // 2))
        _, eng, state, stream = build()
        chunks = [stream.next(STEPS), stream.next(STEPS)]
        calls = iter(chunks)
        sites, err = _syncs(lambda: eng.run_epoch(
            state, next(calls), epoch_buffers(eng, STEPS, dev), 0))
        out[label] = {"dtoh_per_run": n,
                      "syncs_per_step": sum(sites.values()) / STEPS,
                      "sync_sites": sites, "epoch_error": err}
    with torch.inference_mode():
        svc = serve_service(dev)
        svc.step()                                            # warm
        n_slots = len(svc.batcher.running)
        sites, _ = _syncs(svc.step, guard=False)
    syncs = sum(sites.values())
    out["serve"] = {"syncs_per_decode_step": syncs,
                    "syncs_per_token": syncs / max(n_slots, 1),
                    "sync_sites": sites}
    return out


def findings(stats: dict) -> list[Finding]:
    """REPRO-CARD-HOST-TRANSFER findings of :func:`measure`'s counts."""
    found = []
    for label, s in stats.items():
        if label == "serve":
            continue
        path = ENGINE if label == "fused" else PROTOCOL
        if s["dtoh_per_run"] != 1:
            found.append(Finding(
                "REPRO-CARD-HOST-TRANSFER", path, 0,
                f"{label}: run() does not make exactly one device->host "
                "copy (the metric buffers once)",
                "keep metrics in on-device buffers; copy them to the host "
                "once after the last epoch"))
        if s["epoch_error"] is not None:
            found.append(Finding(
                "REPRO-CARD-HOST-TRANSFER", path, 0,
                f"{label}: run_epoch synchronizes with the host under "
                "set_sync_debug_mode('error')",
                "move the host read out of the step (REPRO-HOST-SYNC "
                "names the line)"))
    return found


def check(root) -> list[Finding]:
    return findings(measure())


register(Rule(
    rule_id="REPRO-CARD-HOST-TRANSFER",
    scope="card",
    description="on the card (smoke preset): `EpochEngine.run` and "
                "`ProtocolEngine.run` (`naive`, `sharded`) make exactly one "
                "device->host copy (`torch.profiler`); `run_epoch` runs "
                "under `set_sync_debug_mode(\"error\")`",
    check=check,
    fix_hint="one host copy per run; no sync inside an epoch",
))

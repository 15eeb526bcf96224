"""Layer 2 — a run on the CPU (``python -m repro_torch.analyze --run``).

Layer 1 reads source; this layer runs the port's real entry points — the
``smoke`` preset through the fused engine and the protocol engine (both
collective engines), one serve decode step, and the protocol's scatter
step counted on a :class:`~repro_torch.launch.mesh.RankView` — and
checks what they did. It replaces the reference's two HLO rules that do
not need a device (``repro/analyze/hlo.py``):

* **REPRO-RUN-INPLACE** (for REPRO-HLO-DONATION) — eager PyTorch has no
  donation: an engine that writes a new tensor for its state every step
  doubles the state's memory for a moment and frees it again. So after
  ``run_epoch`` of the fused engine and of the protocol engine (``naive``
  and ``sharded``), and after one serve decode step, every tensor of the
  state (one dimension or more: the replicas, the worker stacks, the
  optimizer state) and of each replica's KV cache must keep its storage
  (``untyped_storage().data_ptr()`` before and after). One finding per
  tensor that moved.
* **REPRO-RUN-COLLECTIVES** (for REPRO-HLO-COLLECTIVES) — for both
  collective engines, on the 1-D lane (rep = G), the (rep, fsdp) lane
  (G = 4 on a (4, 2, 1) mesh) and two 'model' lanes on a (2, 1, 2) mesh
  (``lm/tfm_tiny``'s model, and the smoke preset's MLP at G = 4), one
  scatter step of every rank of the mesh runs
  on meta tensors through ``launch/dryrun.measure`` and the bytes it sends
  by tag must equal the formulas exactly: ``pull`` + ``aggregate`` equal
  ``core/protocol.collective_volume_bytes`` on the rank's columns, and the
  'model' tags ``model_volume_bytes``. The reference allows 10 % between
  its model and the compiled HLO; the port counts what it passes, so the
  tolerance is 0.

Everything imports inside the checks, so layer 1 stays import-free.
"""
from __future__ import annotations

from .findings import Finding
from .registry import Rule, register

#: the audited preset: G = 5 co-located groups, mlp_h32 / mixture5_small
PRESET = "smoke"
#: G = 4 so the 8-rank lane has an 'fsdp' axis: (rep 4, fsdp 2)
FSDP_OVERRIDES = dict(n_workers=4, f_workers=1, n_servers=4, f_servers=0)
#: the 'model' lane of a model family (the MLP's runs PRESET at G = 4)
MODEL_PRESET = "lm/tfm_tiny"
ENGINE = "src/repro_torch/core/engine.py"
PROTOCOL = "src/repro_torch/core/protocol.py"
SERVICE = "src/repro_torch/serve/service.py"


# ---------------------------------------------------------------------------
# the engines on the smoke preset (shared with the card check)
# ---------------------------------------------------------------------------


def fused_engine(device="cpu", **overrides):
    """The smoke preset on the fused runner: (exp, engine, state, stream)."""
    from ..core.engine import EpochEngine
    from ..data.pipeline import DeviceBatchStream
    from ..device import resolve
    from ..exp import presets
    from ..exp.runners import _accuracy
    dev = resolve(device)
    e = presets.get(PRESET, runner="fused", **overrides)
    sim = e.build_sim(device=dev)
    acc = _accuracy(sim, e.build_problem()[2])
    stream = DeviceBatchStream(e.seed, e.mixture, sim.cfg.n_workers, e.batch,
                               dev)
    eng = EpochEngine(sim, acc_fn=acc, eval_set=stream.eval_set(e.eval_n),
                      metrics_every=e.metrics_every)
    return e, eng, sim.init_state(e.seed), stream


def protocol_engine(engine: str, device="cpu", **overrides):
    """The smoke preset on the protocol runner, one process:
    (exp, engine, state, stream)."""
    from ..core.protocol import ProtocolEngine
    from ..data.pipeline import DeviceBatchStream
    from ..device import resolve
    from ..exp import presets
    from ..launch.mesh import make_protocol_mesh
    dev = resolve(device)
    e = presets.get(PRESET, runner="protocol", protocol_engine=engine,
                    **overrides)
    pcfg = e.to_protocol_config()
    stream = DeviceBatchStream(e.seed, e.mixture, pcfg.n_groups, e.batch, dev)
    eng = ProtocolEngine(
        e.build_bundle(), pcfg, e.build_schedule(),
        acc_fn=e.build_problem()[2], eval_set=stream.eval_set(e.eval_n),
        metrics_every=e.metrics_every, device=dev,
        mesh=make_protocol_mesh(pcfg.n_groups))
    return e, eng, eng.init_state(e.seed), stream


def serve_service(device="cpu"):
    """Three replicas of the reduced phi4-mini behind a median
    ``QuorumService`` with two requests admitted and prefilled: the next
    ``step()`` is one decode step."""
    import torch

    from ..device import resolve
    from ..models.registry import get_bundle
    from ..serve import QuorumService, ReplicaPool
    dev = resolve(device)
    bundle = get_bundle("phi4-mini-3.8b", reduced=True)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    pool = ReplicaPool.from_params(params, 3, f=1)
    svc = QuorumService(pool, bundle, n_slots=2, max_len=32)
    for p in ([1, 2, 3, 4], [5, 6, 7]):
        svc.submit(p, max_new=4)
    svc.step()                      # admits and prefills both
    return svc


# ---------------------------------------------------------------------------
# REPRO-RUN-INPLACE
# ---------------------------------------------------------------------------


def storages(obj, prefix: str = "") -> dict[str, int]:
    """``name -> storage address`` of every tensor of one dimension or more
    in ``obj`` (NamedTuples, tuples, lists and dicts walked)."""
    import torch
    out: dict[str, int] = {}
    if isinstance(obj, torch.Tensor):
        if obj.dim() > 0:
            out[prefix] = obj.untyped_storage().data_ptr()
    elif hasattr(obj, "_fields"):
        for k in obj._fields:
            out.update(storages(getattr(obj, k), f"{prefix}.{k}".lstrip(".")))
    elif isinstance(obj, (tuple, list)):
        for i, v in enumerate(obj):
            out.update(storages(v, f"{prefix}[{i}]"))
    elif isinstance(obj, dict):
        for k, v in obj.items():
            out.update(storages(v, f"{prefix}.{k}".lstrip(".")))
    return out


def moved(before: dict, after: dict) -> list[str]:
    """The tensors whose storage changed (or vanished)."""
    return sorted(k for k, p in before.items() if after.get(k) != p)


def _inplace_finding(label: str, path: str, names: list[str]) -> Finding:
    return Finding(
        "REPRO-RUN-INPLACE", path, 0,
        f"{label}: {', '.join(names)} took a new storage — the step writes "
        "a new tensor where it could update the state in place",
        "write the step's result into the state's tensors (copy_, the "
        "in-place ops, out=)")


def epoch_buffers(eng, steps: int, device) -> dict:
    import torch
    names = (["acc"] if eng.acc_fn is not None else []) + (
        ["delta_pre", "delta", "l2_diam"] if eng.track_delta else [])
    bufs = {k: torch.zeros(steps, device=device) for k in names}
    if getattr(eng.cfg, "variant", None) == "sync":
        bufs["rejects"] = torch.zeros((steps, eng.cfg.n_workers),
                                      device=device)
    return bufs


def check_inplace(root) -> list[Finding]:
    import torch
    found: list[Finding] = []
    steps = 6                        # crosses the T = 5 gather boundary
    lanes = [("fused", ENGINE, fused_engine)]
    lanes += [(f"protocol[{eng}]", PROTOCOL,
               lambda eng=eng: protocol_engine(eng))
              for eng in ("naive", "sharded")]
    for label, path, build in lanes:
        _, eng, state, stream = build()
        before = storages(state)
        state = eng.run_epoch(state, stream.next(steps),
                              epoch_buffers(eng, steps, "cpu"), 0)
        gone = moved(before, storages(state))
        if gone:
            found.append(_inplace_finding(f"{label} run_epoch", path, gone))
    with torch.inference_mode():
        svc = serve_service()
        before = storages(svc.caches)
        svc.step()
        gone = moved(before, storages(svc.caches))
        if gone:
            found.append(_inplace_finding("serve decode step", SERVICE,
                                          gone))
    return found


# ---------------------------------------------------------------------------
# REPRO-RUN-COLLECTIVES
# ---------------------------------------------------------------------------


def rank_bytes(bundle, pcfg, shape, batch, rank: int):
    """One scatter step of ``rank`` of a ``shape`` mesh on meta tensors:
    (its bytes sent by tag, its state)."""
    from ..core import protocol
    from ..launch import dryrun
    from ..launch.mesh import AXES, RankView
    from ..optim.schedules import inverse_linear
    view = RankView(AXES, shape, rank=rank)
    state = protocol.make_init_fn(bundle, pcfg, "meta", view)(0)
    step = protocol.make_scatter_step(bundle, pcfg,
                                      inverse_linear(0.05, 0.05), mesh=view)
    fig, _ = dryrun.measure(step, (state, batch), view)
    return ({k: int(v) for k, v in fig["collective_bytes_by_kind"].items()},
            state)


def lanes():
    """(label, bundle, pcfg, mesh shape, meta batch, model-tag formula or
    None) of each audited lane and engine."""
    import torch

    from ..core import protocol
    from ..core.simulator import FlatTree
    from ..exp import presets
    out = []
    for engine in ("naive", "sharded"):
        for tag, overrides, shape_of in (
                ("1-D", {}, lambda G: (G, 1, 1)),
                ("rep x fsdp", FSDP_OVERRIDES, lambda G: (G, 2, 1)),
                ("mlp model", FSDP_OVERRIDES, lambda G: (2, 1, 2))):
            e = presets.get(PRESET, runner="protocol",
                            protocol_engine=engine, **overrides)
            pcfg = e.to_protocol_config()
            bundle = e.build_bundle()
            G = pcfg.n_groups
            batch = (torch.empty((G, e.batch, e.mixture.dim), device="meta"),
                     torch.empty((G, e.batch), dtype=torch.long,
                                 device="meta"))
            rep, _, M = shape_of(G)
            tp = protocol.model_volume_bytes(
                bundle.cfg, M, e.batch, n_groups=G // rep,
                tree=FlatTree.from_params(bundle.meta_params())) \
                if M > 1 else None
            out.append((f"{tag} [{engine}]", bundle, pcfg, shape_of(G),
                        batch, tp))
        e = presets.get(MODEL_PRESET, protocol_engine=engine)
        pcfg = e.to_protocol_config()
        bundle = e.build_bundle()
        G, rep, M, B, S = pcfg.n_groups, 2, 2, 2, 16     # G = 4
        batch = {k: torch.empty((G, B, S), dtype=torch.long, device="meta")
                 for k in ("tokens", "labels")}
        tp = protocol.model_volume_bytes(bundle.cfg, M, B * S,
                                         n_groups=G // rep)
        out.append((f"model [{engine}]", bundle, pcfg, (rep, 1, M), batch,
                    tp))
    return out


def check_collectives(root) -> list[Finding]:
    import numpy as np

    from ..core import protocol
    found: list[Finding] = []
    for label, bundle, pcfg, shape, batch, tp in lanes():
        for rank in range(int(np.prod(shape))):
            got, state = rank_bytes(bundle, pcfg, shape, batch, rank)
            ranks = protocol._Ranks(state.mesh, pcfg.n_groups,
                                    state.tree.size, pcfg.chunk_bytes,
                                    state.split)
            cols = ranks.k1 - ranks.k0
            want = protocol.collective_volume_bytes(pcfg, cols,
                                                    rep=shape[0])
            have = got.get("pull", 0) + got.get("aggregate", 0)
            if have != want:
                found.append(Finding(
                    "REPRO-RUN-COLLECTIVES", PROTOCOL, 0,
                    f"{label} mesh {shape} rank {rank}: pull + aggregate "
                    f"sent {have} bytes, collective_volume_bytes gives "
                    f"{want} on the rank's {cols} columns",
                    "keep collective_volume_bytes equal to what the "
                    "scatter step passes to the mesh"))
            for tag, n in (tp or {}).items():
                if got.get(tag, 0) != n:
                    found.append(Finding(
                        "REPRO-RUN-COLLECTIVES", PROTOCOL, 0,
                        f"{label} mesh {shape} rank {rank}: '{tag}' sent "
                        f"{got.get(tag, 0)} bytes, model_volume_bytes "
                        f"gives {n}",
                        "keep model_volume_bytes equal to what the split "
                        "forms pass over 'model'"))
    return found


register(Rule(
    rule_id="REPRO-RUN-INPLACE",
    scope="run",
    description="after `run_epoch` (fused; protocol `naive` and "
                "`sharded`) and one serve decode step on the CPU, every "
                "state and KV-cache tensor keeps its storage",
    check=check_inplace,
    fix_hint="update the state in place",
))

register(Rule(
    rule_id="REPRO-RUN-COLLECTIVES",
    scope="run",
    description="one scatter step per rank on a `RankView` (1-D, rep x "
                "fsdp and 'model' lanes, both engines): bytes by tag equal "
                "`collective_volume_bytes` / `model_volume_bytes` exactly",
    check=check_collectives,
    fix_hint="keep the byte model equal to what the mesh is passed",
))

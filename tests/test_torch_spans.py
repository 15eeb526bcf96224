"""The port's spans and marks (:mod:`repro_torch.spans`) under
``torch.profiler`` on the CPU: the ByzSGD train step opens each phase's
span once a step, in order, with the model and the flat copies once per
group inside the gradients, and the DMC gather once every T steps; the
scans open their span in the forward and again in the remat recompute;
``byzsgd.host_sync`` counts the step's device-to-host reads. With the
profiler off no range opens, and the step's outputs are the same bits
with the profiler on or off. ``launch/train.py --trace`` writes the spans
to a Chrome trace."""
import json

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.core import protocol
from repro_torch.core.attacks import ByzantineSpec
from repro_torch.core.simulator import FlatTree
from repro_torch.data.pipeline import DeviceTokenStream, TokenSpec
from repro_torch.launch import train
from repro_torch.models.registry import get_bundle
from repro_torch.optim.schedules import inverse_linear

G, T, STEPS = 4, 2, 4
PHASES = ["byzsgd.pull", "byzsgd.grads", "byzsgd.attack", "byzsgd.select",
          "byzsgd.aggregate", "byzsgd.update"]
PREFIXES = ("byzsgd.", "rwkv6.", "mamba2.")


def _steps(traced: bool):
    """``STEPS`` train steps of the reduced phi4-mini at G = 4, ALIE on one
    worker, T = 2; returns the final params and, when ``traced``, the
    program's span records ``(start, end, thread, name)`` in start
    order."""
    bundle = get_bundle("phi4-mini-3.8b", reduced=True)
    pcfg = protocol.ProtocolConfig.derive(
        G, T=T, byz=ByzantineSpec(worker_attack="alie", n_byz_workers=1))
    state = protocol.make_init_fn(bundle, pcfg, "cpu")(0)
    step = protocol.make_train_step(bundle, pcfg, inverse_linear(0.02, 0.005),
                                    with_attack=True)
    stream = DeviceTokenStream(0, TokenSpec(bundle.cfg.vocab, 16), G, 2,
                               "cpu")
    batches = [{k: v[0] for k, v in stream.next(1).items()}
               for _ in range(STEPS)]
    if not traced:
        for b in batches:
            state = step(state, b)
        return state.params, []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for b in batches:
            state = step(state, b)
    return state.params, _records(prof)


def _records(prof):
    return sorted((e.start_ns(), e.end_ns(), e.start_thread_id(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(PREFIXES))


@pytest.fixture(scope="module")
def traced():
    return _steps(traced=True)


def _inside(recs, outer):
    a, b, thread, _ = outer
    return [r for r in recs if r[2] == thread and a <= r[0] and r[1] <= b
            and r is not outer]


def _children(recs, outer):
    """The spans directly inside ``outer``, in start order."""
    inner = _inside(recs, outer)
    return [r for r in inner if not any(
        o is not r and o[0] <= r[0] and r[1] <= o[1] for o in inner)]


@pytest.mark.parametrize("check", ["phases", "groups", "host_sync"])
def test_step_spans(traced, check):
    _, recs = traced
    steps = [r for r in recs if r[3] == "byzsgd.step"]
    assert len(steps) == STEPS
    if check == "phases":
        for i, s in enumerate(steps):
            names = [r[3] for r in _children(recs, s)]
            want = PHASES + (["byzsgd.gather"] if (i + 1) % T == 0 else [])
            assert names == want, (i, names)
        assert sum(r[3] == "byzsgd.gather" for r in recs) == STEPS // T
    elif check == "groups":
        for g in (r for r in recs if r[3] == "byzsgd.grads"):
            names = [r[3] for r in _children(recs, g)]
            assert names == ["byzsgd.model", "byzsgd.flatten"] * G, names
        assert sum(r[3] == "byzsgd.model" for r in recs) == G * STEPS
    else:
        marks = [r for r in recs if r[3] == "byzsgd.host_sync"]
        pulls = [r for r in recs if r[3] in ("byzsgd.pull", "byzsgd.gather")]
        assert len(marks) == len(pulls) == STEPS + STEPS // T
        for m in marks:
            assert m[1] - m[0] < 10**6      # zero-length: the range's cost
            assert sum(p[0] <= m[0] and m[1] <= p[1] for p in pulls) == 1


@pytest.mark.parametrize("arch,name", [("rwkv6-3b", "rwkv6.wkv"),
                                       ("zamba2-1.2b", "mamba2.ssd")])
def test_scan_span_opens_in_the_forward_and_the_recompute(arch, name):
    bundle = get_bundle(arch, reduced=True)
    params = bundle.init(torch.Generator().manual_seed(0))
    stream = DeviceTokenStream(0, TokenSpec(bundle.cfg.vocab, 24), 1, 2,
                               "cpu")
    batch = {k: v[0, 0] for k, v in stream.next(1).items()}
    leaves = [p.requires_grad_()
              for p in FlatTree.from_params(params).leaves(params)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("forward"):
            loss = bundle.loss(params, batch)
        with spans.span("backward"):
            torch.autograd.grad(loss, leaves, allow_unused=True)
    recs = sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name() in (name, "forward", "backward"))
    (fwd,) = [r for r in recs if r[2] == "forward"]
    (bwd,) = [r for r in recs if r[2] == "backward"]
    scans = [r for r in recs if r[2] == name]
    in_fwd = [r for r in scans if fwd[0] <= r[0] and r[1] <= fwd[1]]
    in_bwd = [r for r in scans if bwd[0] <= r[0] and r[1] <= bwd[1]]
    assert in_fwd and len(in_bwd) == len(in_fwd)
    assert len(scans) == 2 * len(in_fwd)


def test_no_range_opens_with_the_profiler_off(monkeypatch):
    opened = []
    real = autograd_profiler.record_function

    def counted(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(autograd_profiler, "record_function", counted)
    with spans.span("byzsgd.step"):
        spans.mark("byzsgd.host_sync")
    _steps(traced=False)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("byzsgd.step"):
            spans.mark("byzsgd.host_sync")
    assert opened == ["byzsgd.step", "byzsgd.host_sync"]


def test_outputs_are_the_same_bits_traced_or_not(traced):
    plain, _ = _steps(traced=False)
    assert torch.equal(traced[0], plain)


def test_train_trace_holds_the_spans(tmp_path):
    path = tmp_path / "step.json"
    train.main(["--reduced", "--device", "cpu", "--steps", "3", "--groups",
                "4", "--seq", "16", "--batch-per-group", "2", "--T", "2",
                "--log-every", "10", "--trace", str(path)])
    doc = json.loads(path.read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"byzsgd.step", "byzsgd.pull", "byzsgd.model",
            "byzsgd.gather"} <= names

"""The system under test: the port's ByzSGD training step
(``repro_torch.core.protocol.make_train_step``, the step
``repro_torch.launch.train`` builds), set up from the benchmark's inputs.

This is the one module of the benchmark that imports the program. It puts
the checkout's ``src`` on ``sys.path``, builds the cell's model bundle, the
protocol configuration of the traffic mix, a ``TraceDelivery`` over the
benchmark's quorum tables, and the replica stack from the benchmark's
initial model; it reads back the program's losses (through the bundle's
loss), MDA's picks (through ``quorum_weights``) and its replicas.
The step runs in the configuration's own ``param_dtype`` and
``act_dtype``. ``fault`` plants one of the faults the tests of the
comparison use
(:data:`FAULTS`): a step that leaves the state unchanged, half of each
group's rows left out, the largest leaf of replica 0 moved twice as far
as the step moves it, or server 0's pick replaced by the subset of
largest diameter.
"""
from __future__ import annotations

import dataclasses
import importlib
import itertools
import sys
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from . import inputs
from .reference import protocol as ref

SRC = Path(__file__).resolve().parents[1] / "src"

#: faults planted in the timed path for the tests of the comparison
FAULTS = ("unchanged", "half_batch", "altered", "bad_pick")


def port():
    """The port's modules the benchmark drives (imported on first use)."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    from repro_torch import optim
    from repro_torch.core import protocol
    from repro_torch.core.attacks import ByzantineSpec
    from repro_torch.core.quorum import TraceDelivery
    from repro_torch.core.simulator import FlatTree
    from repro_torch.kernels import _build
    from repro_torch.models.registry import get_bundle
    from repro_torch.optim.schedules import inverse_linear
    return dict(optim=optim, protocol=protocol, ByzantineSpec=ByzantineSpec,
                TraceDelivery=TraceDelivery, FlatTree=FlatTree,
                build=_build, get_bundle=get_bundle,
                inverse_linear=inverse_linear)


def build_kernels() -> None:
    """Compile every kernel library the checkout lacks, all at once (a
    checkout's first run), so no step waits for ``nvcc``."""
    port()["build"].build()


class Program:
    """One cell's training step and its state, on ``device``."""

    def __init__(self, cell, seed: int, device, *, fault=None):
        m = port()
        c, tr = cell.config, cell.traffic
        self.fault, self.tr = fault, tr
        spec = c["port"]
        bundle = m["get_bundle"](spec["arch"], reduced=spec.get("reduced",
                                                                 False),
                                 depth=spec.get("depth"))
        # the precision is the configuration's, whatever the port's default
        cfg = bundle.cfg = dataclasses.replace(
            bundle.cfg, param_dtype=c["param_dtype"], act_dtype=c["act_dtype"])
        # the flat layout the benchmark's weights are made in, which is the
        # program's own (bench/tests hold the two equal)
        sp = ref.spans(c)
        tree = m["FlatTree"]([tuple(path.split("/")) for path, *_ in sp],
                             [shape for _, shape, _, _ in sp])
        self.bundle, self.tree = bundle, tree
        G, f_w, f_ps = tr["groups"], tr["f_workers"], tr["f_servers"]
        byz = m["ByzantineSpec"](worker_attack=tr["worker_attack"],
                                 n_byz_workers=tr["n_byz_workers"])
        pcfg = m["protocol"].ProtocolConfig.derive(
            G, T=tr["T"], byz=byz, f_workers=f_w, f_servers=f_ps,
            q_workers=G - f_w, q_servers=G - f_ps)
        tables = inputs.quorum_tables(seed, tr)
        delivery = m["TraceDelivery"](tables["pull"], tables["push"],
                                      tables["gather"], tr["T"],
                                      device=device)
        self.step_fn = m["protocol"].make_train_step(
            bundle, pcfg, m["inverse_linear"](tr["lr"], tr["lr_decay"]),
            with_attack=True, delivery=delivery)
        self.losses: list = []
        self.recording = False
        self.loss_range = None      # a range name around the loss, traced
        self._wrap_loss()
        p0 = inputs.make_weights(c, seed, device)
        pdt = getattr(torch, cfg.param_dtype)
        params = torch.empty((G, p0.shape[0]), dtype=pdt, device=device)
        params.copy_(p0.expand_as(params))
        del p0
        gen = torch.Generator(device=device).manual_seed(
            inputs.stream_seed(seed, "program"))
        self.state = m["protocol"].ByzState(
            params=params, t=tr["t0"], gen=gen,
            opt=m["optim"].get(pcfg.optimizer).init(params), tree=tree)

    def _wrap_loss(self):
        loss, fault = self.bundle.loss, self.fault

        def recorded(params, batch):
            if fault == "half_batch":
                batch = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            if self.loss_range:
                with torch.profiler.record_function(self.loss_range):
                    out = loss(params, batch)
            else:
                out = loss(params, batch)
            if self.recording:
                self.losses.append(out.detach().float())
            return out

        self.bundle.loss = recorded

    def step(self, batch) -> None:
        if self.fault == "unchanged":
            return
        if self.fault == "altered":
            # the largest leaf of replica 0 moved twice as far as the step
            # moves it
            o, n = max(self.tree.spans(), key=lambda span: span[1])
            before = self.state.params[0, o:o + n].clone()
            self.state = self.step_fn(self.state, batch)
            row = self.state.params[0, o:o + n]
            row.add_(row - before)
            return
        self.state = self.step_fn(self.state, batch)

    @contextmanager
    def picks_read(self):
        """Inside the block, every step's MDA pick of every server is kept
        (``self.picks``, ``[step][server]`` sorted sender lists)."""
        proto = port()["protocol"]
        weights, fault, kept = proto.quorum_weights, self.fault, []

        def read(d2, idx, f, cfg):
            w = weights(d2, idx, f, cfg)
            if fault == "bad_pick":
                w = _worst_pick(w, d2, idx, f)
            kept.append(w)
            return w

        proto.quorum_weights = read
        try:
            yield
        finally:
            proto.quorum_weights = weights
            self.picks = [[sorted(int(i) for i in torch.nonzero(r))
                           for r in w.cpu()] for w in kept]

    @contextmanager
    def ranges_on(self, targets: dict):
        """Name ranges in traced steps: ``{range name: "bundle.loss"}``
        marks the model's loss (with its backward, the model), and
        ``{name: "module:function"}`` wraps a function of the port."""
        patched = []
        for name, target in targets.items():
            if target == "bundle.loss":
                self.loss_range = name
                continue
            mod_name, attr = target.split(":")
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)

            def ranged(*a, _fn=fn, _name=name, **k):
                with torch.profiler.record_function(_name):
                    return _fn(*a, **k)

            setattr(mod, attr, ranged)
            patched.append((mod, attr, fn))
        try:
            yield
        finally:
            self.loss_range = None
            for mod, attr, fn in patched:
                setattr(mod, attr, fn)

    def readings(self, p0: torch.Tensor) -> np.ndarray:
        """Each leaf's norm of each replica's distance from the initial
        model ``p0``: ``[G, leaves]`` float64."""
        params = self.state.params
        out = np.zeros((params.shape[0], len(self.tree.spans())))
        for g in range(params.shape[0]):
            for i, (o, n) in enumerate(self.tree.spans()):
                d = params[g, o:o + n].float() - p0[o:o + n]
                out[g, i] = float(torch.linalg.vector_norm(d))
        return out

    def losses_read(self) -> np.ndarray:
        """The losses recorded since recording began, ``[steps, G]``."""
        G = self.tr["groups"]
        vals = [float(x) for x in self.losses]
        if len(vals) % G:
            vals += [float("nan")] * (G - len(vals) % G)
        return np.array(vals).reshape(-1, G)

    def free(self) -> None:
        """Drop the program's state and the step's buffers."""
        self.state = self.step_fn = self.bundle = None


def _worst_pick(w, d2, idx, f):
    """``w`` with server 0's weights moved to the delivered subset of
    ``q - f`` senders whose largest pairwise distance is largest."""
    q = [int(i) for i in idx[0]]
    worst = max(itertools.combinations(q, len(q) - f), key=lambda sub: max(
        float(d2[i, j]) for i, j in itertools.combinations(sub, 2)))
    w = w.clone()
    w[0] = 0.0
    w[0, list(worst)] = 1.0 / len(worst)
    return w

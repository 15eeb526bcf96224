"""Single-host ByzSGD simulator — the port of ``repro.core.simulator``.

Simulates n_ps parameter servers and n_w workers (both with Byzantine
members) on one device. Protocol semantics (quorums, GARs, the scatter/gather
schedule, filters, attacks) are the JAX package's; the network is replaced by
a delivery model (``quorum.py``).

Layout: every replica stack is ONE flat float32 tensor — server models
``[n_ps, D]``, worker models and gradients ``[n_w, D]``, equivocated views
``[n_recv, n, D]`` — where D is the model's parameter count in the JAX
package's leaf order (:class:`FlatTree`). The model sees a dict of views. The
JAX package's ``vmap`` over receivers becomes the batch dimension of one
aggregation per role and step (one kernel launch for all receivers), and the
per-worker gradients come from ``torch.func.vmap(torch.func.grad(...))`` over
the workers' models and batches. The step counter ``t`` lives on the host
(the schedule's branches are host decisions in eager PyTorch), the
randomness in the state's ``torch.Generator``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple

import torch

from .. import agg
from ..device import resolve
from .attacks import ByzantineSpec, inject_gradients, inject_models
from .filters import (LipschitzHistory, lipschitz_coefficient,
                      lipschitz_cutoff, outliers_bound, outliers_pass)
from .quorum import UniformDelivery, validate_counts


class FlatTree:
    """Names, shapes and offsets of a model's leaves in the flat layout, in
    the JAX package's leaf order (sorted keys, depth first)."""

    def __init__(self, paths: list[tuple[str, ...]], shapes: list[tuple]):
        self.paths = list(paths)
        self.shapes = [tuple(s) for s in shapes]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.offsets = [sum(self.sizes[:i]) for i in range(len(self.sizes))]
        self.size = sum(self.sizes)

    @classmethod
    def from_params(cls, params: dict, lead: int = 0) -> "FlatTree":
        """The tree of a nested dict of leaves (``lead`` leading stack dims
        are not part of a leaf's shape)."""
        paths, shapes = [], []

        def walk(t, path):
            if isinstance(t, dict):
                for k in sorted(t):
                    walk(t[k], path + (k,))
            else:
                paths.append(path)
                shapes.append(tuple(t.shape[lead:]))

        walk(params, ())
        return cls(paths, shapes)

    def spans(self) -> list[tuple[int, int]]:
        return list(zip(self.offsets, self.sizes))

    def leaves(self, params: dict) -> list:
        out = []
        for path in self.paths:
            node = params
            for k in path:
                node = node[k]
            out.append(node)
        return out

    def flatten(self, params: dict, lead: int = 0) -> torch.Tensor:
        """Nested dict of ``[*lead, *shape]`` leaves -> ``[*lead, D]``
        float32."""
        ls = self.leaves(params)
        pre = tuple(ls[0].shape[:lead])
        return torch.cat([l.reshape(pre + (-1,)).float() for l in ls],
                         dim=-1)

    def unflatten(self, flat: torch.Tensor) -> dict:
        """``[.., D]`` -> nested dict of ``[.., *shape]`` views."""
        out: dict = {}
        pre = tuple(flat.shape[:-1])
        for path, shape, off, size in zip(self.paths, self.shapes,
                                          self.offsets, self.sizes):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = flat[..., off:off + size].reshape(pre + shape)
        return out


@dataclass(frozen=True)
class ByzSGDConfig:
    n_workers: int = 9
    f_workers: int = 2          # declared bound
    n_servers: int = 5
    f_servers: int = 1          # declared bound
    q_workers: int | None = None   # gradients a server waits for (async)
    q_servers: int | None = None   # models a node waits for (async)
    T: int = 10                 # scatter length (gather every T steps)
    gar: str = "mda"            # worker-gradient GAR at servers
    pull_gar: str = "median"    # model GAR at workers (async pull)
    gather_gar: str = "median"  # server-model GAR in the DMC gather
    worker_gar: str = "meamed"  # worker model refresh in the sync gather
    variant: str = "async"      # "async" | "sync"
    mda_exact_limit: int = 200_000
    lip_horizon: int = 128
    byz: ByzantineSpec = field(default_factory=ByzantineSpec)

    def __post_init__(self):
        qw = self.q_workers or (self.n_workers - self.f_workers)
        qs = self.q_servers or max(self.n_servers - self.f_servers,
                                   2 * self.f_servers + 2)
        object.__setattr__(self, "q_workers", qw)
        object.__setattr__(self, "q_servers", qs)
        validate_counts(self.n_workers, self.f_workers, self.n_servers,
                        self.f_servers, qw, qs,
                        synchronous=(self.variant == "sync"))
        # GARs resolve in the port's registry, their f bounds hold for the
        # smallest stack each role aggregates, and they take a model stack
        for role, name, n, f in (("gar", self.gar, qw, self.f_workers),
                                 ("pull_gar", self.pull_gar, qs,
                                  self.f_servers),
                                 ("gather_gar", self.gather_gar, qs,
                                  self.f_servers),
                                 ("worker_gar", self.worker_gar,
                                  self.n_servers, self.f_servers)):
            spec = agg.get(name)
            if spec.tree_mode is None:
                raise ValueError(f"{role}={name!r} does not support pytree "
                                 "aggregation (tree_mode=None)")
            spec.validate(n, f)

    @property
    def h_servers(self) -> int:
        return self.n_servers - self.byz.n_byz_servers

    @property
    def h_workers(self) -> int:
        return self.n_workers - self.byz.n_byz_workers


class SimState(NamedTuple):
    params: torch.Tensor      # [n_ps, D] — one replica per server
    t: int                    # host step counter
    gen: torch.Generator      # quorum sampling and stochastic attacks
    # sync-variant worker state (carried in async for uniformity)
    w_model: torch.Tensor     # [n_w, D]
    w_grad: torch.Tensor      # [n_w, D]
    w_r: torch.Tensor         # [n_w] round-robin offsets
    lip: LipschitzHistory     # buf [n_w, H]
    anchor_eta: torch.Tensor  # eta at the last gather (Outliers anchor)
    anchor_gnorm: torch.Tensor  # ||g|| at the last gather


def tree_gnorm(vec: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(vec.float() ** 2))


def coordinatewise_diameter_sum(params: torch.Tensor,
                                h_servers: int) -> torch.Tensor:
    """Delta_t of Lemma 4.2: the sum over coordinates of the max-min spread
    across *honest* server replicas."""
    hl = params[:h_servers].float()
    return torch.sum(torch.amax(hl, dim=0) - torch.amin(hl, dim=0))


def l2_diameter(params: torch.Tensor, h_servers: int) -> torch.Tensor:
    """Max pairwise L2 distance between honest replicas (on the Gram
    kernel)."""
    return torch.sqrt(torch.amax(agg.pairwise_sqdists(
        params[:h_servers].float())))


def _take(seen: torch.Tensor, idx: torch.Tensor, equivocated: bool):
    """Each receiver's delivered rows: ``seen [n, D]`` (or per receiver
    ``[n_recv, n, D]``) and ``idx [n_recv, q]`` -> ``[n_recv, q, D]``."""
    if equivocated:
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
        return seen[rows, idx]
    return seen[idx]


class ByzSGDSimulator:
    """``init_fn(gen, device) -> params dict``; ``loss_fn(params, batch) ->
    scalar``; ``lr_schedule(t) -> float`` (a float32 value).

    ``delivery`` plugs in the asynchrony model: :class:`UniformDelivery`
    (the default) or a :class:`~.quorum.TraceDelivery`.
    """

    def __init__(self, cfg: ByzSGDConfig, init_fn: Callable,
                 loss_fn: Callable, lr_schedule: Callable,
                 delivery=None, device=None):
        self.cfg = cfg
        self.init_fn = init_fn
        self.loss_fn = loss_fn
        self.lr = lr_schedule
        self.device = resolve(device)
        self.delivery = delivery or UniformDelivery.from_config(cfg)
        self.tree = FlatTree.from_params(
            init_fn(torch.Generator().manual_seed(0), device="cpu"))
        tree = self.tree

        def loss_flat(theta, batch):
            return self.loss_fn(tree.unflatten(theta), batch)

        self._grad = torch.func.grad(loss_flat)
        self._grads = torch.func.vmap(self._grad)

    # -- state ------------------------------------------------------------
    def init_state(self, seed: int) -> SimState:
        """All correct servers start from the same model (§3.3)."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        flat = self.tree.flatten(self.init_fn(gen, device=dev))
        return self.state_from(flat, torch.Generator(device=dev).manual_seed(
            seed + 1))

    def state_from(self, flat0: torch.Tensor, gen: torch.Generator,
                   t: int = 0) -> SimState:
        """A fresh state whose servers and workers all hold ``flat0 [D]``."""
        cfg, dev = self.cfg, self.device
        flat0 = flat0.to(dev)
        return SimState(
            params=flat0.expand(cfg.n_servers, -1).clone(),
            t=t, gen=gen,
            w_model=flat0.expand(cfg.n_workers, -1).clone(),
            w_grad=torch.zeros((cfg.n_workers, flat0.shape[0]),
                               dtype=torch.float32, device=dev),
            w_r=torch.arange(cfg.n_workers, device=dev) % cfg.n_servers,
            lip=LipschitzHistory.create(cfg.n_workers, cfg.lip_horizon, dev),
            anchor_eta=torch.tensor(self.lr(0), dtype=torch.float32,
                                    device=dev),
            anchor_gnorm=torch.tensor(1.0, dtype=torch.float32, device=dev))

    def grads(self, models: torch.Tensor, batch) -> torch.Tensor:
        """Per-worker gradients: ``[n_w, D]`` models, batch leaves
        ``[n_w, b, ...]`` -> ``[n_w, D]``."""
        return self._grads(models, batch)

    def _anchors(self, state: SimState, eta: float, gnorm):
        if state.t % self.cfg.T == 0:
            # a fill, not a copy of a host scalar: no sync with the host
            return (torch.full((), eta, dtype=torch.float32,
                               device=self.device), gnorm)
        return state.anchor_eta, state.anchor_gnorm

    # -- async scatter step (Algorithms 1 & 2) ------------------------------
    def scatter_step(self, state: SimState, batch) -> SimState:
        """One asynchronous ByzSGD step. batch leaves: [n_w, per-worker, ...]."""
        cfg, byz, dev = self.cfg, self.cfg.byz, self.device
        eta = self.lr(state.t)

        # 1. workers pull q_ps models and aggregate them (Median): one launch
        #    for all n_w receivers
        pull_idx = self.delivery.pull_indices(state.gen, state.t, dev)
        models_seen = inject_models(
            state.params, byz, state.gen, tree=self.tree,
            n_receivers=cfg.n_workers if byz.equivocates_models else None)
        pulled = agg.tree_agg(cfg.pull_gar, _take(
            models_seen, pull_idx, byz.equivocates_models), cfg.f_servers)

        # 2. workers compute gradients on their microbatch
        grads = self.grads(pulled, batch)

        # 3. Byzantine workers replace their gradient
        grads_seen = inject_gradients(
            grads, byz, state.gen, tree=self.tree,
            n_receivers=cfg.n_servers if byz.equivocates_grads else None)

        # 4. servers aggregate q_w gradients with the GAR and update
        push_idx = self.delivery.push_indices(state.gen, state.t, dev)
        g_hat = agg.tree_agg(cfg.gar, _take(
            grads_seen, push_idx, byz.equivocates_grads), cfg.f_workers,
            exact_limit=cfg.mda_exact_limit)
        new_params = state.params - eta * g_hat

        anchor_eta, anchor_gnorm = self._anchors(state, eta,
                                                 tree_gnorm(grads[0]))
        return state._replace(params=new_params, t=state.t + 1, w_grad=grads,
                              anchor_eta=anchor_eta,
                              anchor_gnorm=anchor_gnorm)

    # -- gather step (DMC, lines 8-10 of Algorithm 2) ------------------------
    def gather_step(self, state: SimState) -> SimState:
        cfg, byz = self.cfg, self.cfg.byz
        gather_idx = self.delivery.gather_indices(state.gen, state.t,
                                                  self.device)
        models_seen = inject_models(
            state.params, byz, state.gen, tree=self.tree,
            n_receivers=cfg.n_servers if byz.equivocates_models else None)
        new_params = agg.tree_agg(cfg.gather_gar, _take(
            models_seen, gather_idx, byz.equivocates_models), cfg.f_servers)
        return state._replace(params=new_params)

    # -- sync-variant worker step (Algorithm 3) ------------------------------
    def sync_step(self, state: SimState, batch):
        """Synchronous variant: servers update from every worker's gradient;
        each worker pulls ONE model (round-robin) and validates it with the
        Lipschitz and Outliers filters. Returns (new_state, diagnostics) with
        per-worker reject counts."""
        cfg, byz, dev = self.cfg, self.cfg.byz, self.device
        eta = self.lr(state.t)
        n_w = cfg.n_workers

        # servers update from the current worker gradients (full delivery)
        grads_seen = inject_gradients(
            state.w_grad, byz, state.gen, tree=self.tree,
            n_receivers=cfg.n_servers if byz.equivocates_grads else None)
        g_hat = agg.tree_agg(cfg.gar, grads_seen, cfg.f_workers,
                             exact_limit=cfg.mda_exact_limit)
        new_params = state.params - eta * g_hat
        models_seen = inject_models(
            new_params, byz, state.gen, tree=self.tree,
            n_receivers=n_w if byz.equivocates_models else None)

        # each worker speculates its local model and tries the servers in
        # round-robin order, accepting the first model that passes BOTH
        # filters. A host loop over the offsets: each round probes every
        # worker (those already done are masked, as JAX's vmapped while_loop
        # masks them) and the loop stops once all are done — about one
        # gradient per worker per step on the honest path.
        bnd = outliers_bound(state.t, cfg.T, state.anchor_eta,
                             state.anchor_gnorm, n_w, cfg.f_workers)
        local = state.w_model - eta * state.w_grad
        kp = lipschitz_cutoff(state.lip, cfg.n_servers, cfg.f_servers)
        rows = torch.arange(n_w, device=dev)
        done = torch.zeros(n_w, dtype=torch.bool, device=dev)
        # fallbacks when no candidate passes: the speculated local model and
        # the previous gradient (a conservative, honest pair)
        new_wm, new_wg = local, state.w_grad
        k0 = torch.zeros(n_w, dtype=torch.float32, device=dev)
        rejects = torch.full((n_w,), cfg.n_servers, dtype=torch.int64,
                             device=dev)
        for off in range(cfg.n_servers):
            if off and bool(done.all()):
                break
            sid = (state.w_r + state.t + 1 + off) % cfg.n_servers
            pulled = (models_seen[rows, sid] if byz.equivocates_models
                      else models_seen[sid])
            g_new = self.grads(pulled, batch)
            k_coef = lipschitz_coefficient(g_new, state.w_grad, local,
                                           state.w_model)
            ok = ((torch.isnan(kp) | (k_coef <= kp))
                  & outliers_pass(pulled, local, bnd))
            if off == 0:
                k0 = k_coef
            take = ok & ~done
            new_wm = torch.where(take[:, None], pulled, new_wm)
            new_wg = torch.where(take[:, None], g_new, new_wg)
            rejects = torch.where(take, off, rejects)
            done = done | ok
        # record the FIRST examined coefficient unconditionally: the paper
        # keeps "all previous Lipschitz coefficients" — the (n-f)/n quantile
        # absorbs the Byzantine fraction; recording only accepted ks biases
        # the cutoff down (a rejection death spiral)
        new_lip = state.lip.push(k0)

        anchor_eta, anchor_gnorm = self._anchors(state, eta,
                                                 tree_gnorm(new_wg[0]))
        # Algorithm 3 guards worker pulls with the Lipschitz + Outliers
        # filters (paper Sec. 4.2), not a GAR — the loop above IS the
        # sanitizer for the w_model write:
        # analyze: ignore[REPRO-TAINT-BYZ] Alg. 3 Lipschitz+Outliers filters guard this pull
        new_state = state._replace(params=new_params, t=state.t + 1,
                                   w_model=new_wm, w_grad=new_wg,
                                   lip=new_lip, anchor_eta=anchor_eta,
                                   anchor_gnorm=anchor_gnorm)
        return new_state, {"rejects": rejects}

    # -- sync gather: workers aggregate all servers with MeaMed --------------
    def sync_gather_step(self, state: SimState) -> SimState:
        cfg, byz = self.cfg, self.cfg.byz
        state = self.gather_step(state)  # server-side DMC
        models_seen = inject_models(
            state.params, byz, state.gen, tree=self.tree,
            n_receivers=cfg.n_workers if byz.equivocates_models else None)
        new_wm = agg.tree_agg(cfg.worker_gar, models_seen, cfg.f_servers)
        if new_wm.ndim == 1:
            new_wm = new_wm.expand(cfg.n_workers, -1).clone()
        return state._replace(w_model=new_wm)

    # -- full training loop ---------------------------------------------------
    def run(self, state: SimState, batches, *,
            metrics_fn: Callable | None = None, metrics_every: int = 10):
        """batches: iterable of per-step batches (leaves ``[n_w, ...]``).
        Returns the final state and a list of metric dicts.

        The *stepwise* reference loop (host metrics every
        ``metrics_every``); :class:`repro_torch.core.engine.EpochEngine` is
        the fused runner, equal to this loop step for step."""
        cfg = self.cfg
        logs: list[dict[str, Any]] = []
        for i, batch in enumerate(batches):
            if cfg.variant == "sync":
                if i > 0 and i % cfg.T == 0:
                    state = self.sync_gather_step(state)
                state, diag = self.sync_step(state, batch)
            else:
                state = self.scatter_step(state, batch)
                diag = {}
                if (i + 1) % cfg.T == 0:
                    state = self.gather_step(state)
            if metrics_fn is not None and i % metrics_every == 0:
                m = dict(metrics_fn(state))
                m["step"] = i
                if "rejects" in diag:
                    m["rejects"] = int(diag["rejects"].sum())
                stal = self.delivery.staleness(i)
                if stal:
                    m.update(stal)
                logs.append(m)
        return state, logs

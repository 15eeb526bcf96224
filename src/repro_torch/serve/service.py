"""`QuorumService` — the replicated inference loop (port of
``repro.serve.service``).

Every decode step runs on **all** replicas, each slot at its own position,
then one quorum read consolidates the per-replica logits ``[R, n_slots, V]``
into the committed next token per slot. Up to f Byzantine replicas cannot
corrupt a continuation, and with bit-identical honest replicas the output is
token-identical to an honest single-replica run.

The JAX service's double ``vmap`` (replicas x slots) becomes explicit
dimensions: slots are the batch rows of one cache whose length is kept per
row, and replicas are a loop over per-replica params in which each replica
computes at the shapes a single replica would (so an R = 1 baseline and an
R = 4 pool give bit-identical honest logits), except the prefill attention,
which takes every replica's rows in one kernel launch. The families
differ only inside the bundle: the MoE, RWKV6 and hybrid (zamba2) decodes
run each slot alone at B = 1 shapes (the MoE routes each slot on its own,
as the JAX service's B = 1 slots do), and a slot's cache is reset before
each prefill (``bundle.reset_cache_rows``): an RWKV6 or Mamba2 state
starts from zero for every request, where the JAX service carries the
slot's last request's state into the next (ROADMAP Queue 3). The vlm and
audio families (embeddings or frames in) are refused, as in JAX.

On top of the device loop: continuous batching
(:class:`~repro_torch.serve.batcher.ContinuousBatcher`), divergence
detection with a same-read retry after an ejection, and metrics (tok/s,
disagreement rate, ejections/retries, per-request latency and deadlines).
Prompts are prefilled unpadded; token-in families only.

On a serve mesh (``rules=``, :func:`repro_torch.launch.steps.serve_rules`
with a 'model' axis; the dense family) each rank holds its blocks of every
replica (a whole pool it is given is cut by :meth:`ReplicaPool.shard`),
the replicas' prefill and decode run tensor-parallel under the table, and
the quorum read runs on each rank's vocab block
(:mod:`repro_torch.serve.quorum`).
The 'data' ranks each run every slot (the batch is the service's slots,
refilled on the host, so it stays whole on every rank).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..models import sharding as shr
from . import quorum
from .batcher import ContinuousBatcher, Request
from .replica import ReplicaPool


class QuorumService:
    """Byzantine-tolerant replicated decode over a :class:`ReplicaPool`."""

    def __init__(self, pool: ReplicaPool, bundle, *, n_slots: int = 4,
                 max_len: int = 128, n_chunks: int = 4, rule: str = "median",
                 detector: quorum.DetectorConfig | None = None,
                 max_queue: int | None = None, rules=None):
        if bundle.cfg.family in ("vlm", "audio"):
            raise ValueError(f"QuorumService serves token-in families only "
                             f"(got {bundle.cfg.family!r})")
        if rule not in quorum.READ_RULES:
            raise ValueError(f"unknown read rule {rule!r}; "
                             f"have {quorum.READ_RULES}")
        self.rules = rules if rules is not None and rules.M > 1 else None
        if self.rules is not None:
            from ..core.simulator import FlatTree
            from ..launch.steps import serve_param_sharding
            from ..models.registry import check_model_axis
            check_model_axis(bundle.cfg, self.rules.M)
            if not pool.sharded:
                tree = FlatTree.from_params(pool.params, lead=1)
                pool = pool.shard(serve_param_sharding(
                    tree, self.rules.mesh, bundle.cfg), self.rules.mesh)
        self.pool = pool
        self.bundle = bundle
        self.rule = rule
        self.max_len = max_len
        self.batcher = ContinuousBatcher(n_slots, max_queue=max_queue)
        self.detector = quorum.DivergenceDetector(pool.n_replicas, pool.f,
                                                  detector)
        self.device = pool.params["embed"]["table"].device
        # one cache per replica: k/v [L, n_slots, ...], length [L, n_slots]
        with shr.sharding_rules(self.rules):
            self.caches = [bundle.init_caches(n_slots, max_len=max_len,
                                              n_chunks=n_chunks,
                                              device=self.device)
                           for _ in range(pool.n_replicas)]

        # metrics
        self.committed = 0
        self.decode_s = 0.0
        self.reads = 0
        self.disagreement_sum = 0.0
        self.ejections: list[tuple[int, int]] = []   # (read idx, replica)
        self.retries = 0
        self.requests: list[Request] = []

    # -- admission ---------------------------------------------------------
    def submit(self, prompt, max_new: int = 8,
               deadline_ms: float | None = None) -> Request:
        req = self.batcher.submit(prompt, max_new=max_new,
                                  deadline_ms=deadline_ms)
        self.requests.append(req)
        return req

    # -- membership --------------------------------------------------------
    def readmit(self, i: int) -> bool:
        """Re-admit an ejected replica: heal its params from the active
        quorum's median (:meth:`ReplicaPool.reactivate`) and reset its
        detector record with a probation window. Returns False when the
        replica is already active."""
        if not self.pool.reactivate(i):
            return False
        self.detector.readmit(i)
        return True

    # -- quorum read (+ detector, + retry-on-ejection) ---------------------
    def _read(self, logits) -> np.ndarray:
        """One quorum read of per-replica logits ``[R, n_slots, V]`` ->
        committed token per slot ``[n_slots]``, applying the detector and
        retrying the read without any replica it ejects."""
        with shr.sharding_rules(self.rules):
            return self._read_tokens(logits)

    def _read_tokens(self, logits) -> np.ndarray:
        mask = self.pool.active.copy()
        answer = quorum.quorum_logits(logits, self.pool.f, mask=mask)
        dist = self.detector.distances(logits, answer)
        newly = [i for i in self.detector.observe(dist, mask)
                 if self.pool.deactivate(i)]
        if newly:
            self.ejections.extend((self.detector.reads, i) for i in newly)
            self.retries += 1
            mask = self.pool.active.copy()    # retry against the honest rest
        if self.rule == "median" and not newly:
            # the mask is unchanged, so the answer is already the median
            toks = quorum.argmax_vocab(answer).to(torch.int32)
        else:
            toks = quorum.quorum_tokens(logits, self.pool.f, self.rule,
                                        mask=mask)
        toks = toks.cpu().numpy()
        self.reads += 1
        self.disagreement_sum += quorum.disagreement(logits, toks, mask=mask)
        return toks

    # -- device loop -------------------------------------------------------
    def _prefill_into(self, req: Request) -> int:
        """Prefill ``req`` into its slot on every replica; quorum-read and
        commit the first generated token."""
        if len(req.prompt) + req.max_new + 1 > self.max_len:
            raise ValueError(f"request {req.rid}: prompt+max_new exceeds "
                             f"max_len={self.max_len}")
        s = req.slot
        tokens = torch.tensor([req.prompt], dtype=torch.int64,
                              device=self.device)                # [1, P]
        slot = [self.bundle.reset_cache_rows(c, slice(s, s + 1))
                for c in self.caches]
        with shr.sharding_rules(self.rules):
            logits = self.bundle.prefill_replicas(self.pool.replicas(),
                                                  tokens, slot)  # [R, 1, V]
        tok = int(self._read(logits)[0])
        req.out_tokens.append(tok)
        self.committed += 1
        return tok

    def step(self) -> bool:
        """One service tick: expire deadlines, refill slots (prefill), decode
        one token on every replica x slot, quorum-commit. Returns False when
        fully idle."""
        self.batcher.expire()
        for req in self.batcher.fill():
            t0 = time.perf_counter()
            self._prefill_into(req)
            self.decode_s += time.perf_counter() - t0
            if len(req.out_tokens) >= req.max_new:
                self.batcher.finish(req)
        running = self.batcher.running
        if not running:
            return not self.batcher.idle
        last = np.zeros((self.batcher.n_slots, 1), np.int64)
        for r in running:
            last[r.slot, 0] = r.out_tokens[-1]
        t0 = time.perf_counter()
        with shr.sharding_rules(self.rules):
            logits = self.bundle.decode_replicas(
                self.pool.replicas(), self.caches,
                torch.as_tensor(last, device=self.device))
        toks = self._read(logits)
        self.decode_s += time.perf_counter() - t0
        for r in running:
            r.out_tokens.append(int(toks[r.slot]))
            self.committed += 1
            if len(r.out_tokens) >= r.max_new:
                self.batcher.finish(r)
        return not self.batcher.idle

    def generate(self, prompts, max_new: int = 8,
                 deadline_ms: float | None = None) -> list[list[int]]:
        """Submit all prompts, run to idle, return each request's committed
        continuation (token ids)."""
        reqs = [self.submit(p, max_new=max_new, deadline_ms=deadline_ms)
                for p in prompts]
        while self.step():
            pass
        return [r.out_tokens for r in reqs]

    # -- metrics -----------------------------------------------------------
    def report(self) -> dict:
        done = [r for r in self.requests if r.t_done is not None]
        lat = [r.latency_s for r in done]
        return {
            "rule": self.rule,
            "n_replicas": self.pool.n_replicas,
            "n_active": self.pool.n_active,
            "f": self.pool.f,
            "committed_tokens": self.committed,
            "tok_s": self.committed / max(self.decode_s, 1e-9),
            "reads": self.reads,
            "disagreement_rate": self.disagreement_sum / max(self.reads, 1),
            "ejections": list(self.ejections),
            "retries": self.retries,
            "refills": self.batcher.refills,
            "rejected": self.batcher.rejected,
            "requests": {
                "total": len(self.requests),
                "done": sum(r.status == "done" for r in self.requests),
                "deadline": sum(r.status == "deadline" for r in self.requests),
                "latency_s_mean": float(np.mean(lat)) if lat else None,
            },
            "replicas": [
                {"id": i, "active": bool(self.pool.active[i]),
                 "flagged": bool(self.detector.flagged[i]),
                 "strikes": int(self.detector.strikes[i]),
                 "probation": int(self.detector.probation[i])}
                for i in range(self.pool.n_replicas)
            ],
        }

"""Byzantine-tolerant read rules + the divergence detector (port of
``repro.serve.quorum``).

A *quorum read* consolidates the per-replica answers of a
:class:`~repro_torch.serve.replica.ReplicaPool` through a rule registered in
:mod:`repro_torch.agg`:

  * ``median`` — coordinate-wise median over the replica *logits* (on the
    GPU, the median kernel), then the argmax of the consolidated
    distribution. With bit-identical honest replicas the median of
    [corrupt, h, h, h] is exactly h in every coordinate, so continuations
    are token-identical to the honest model.
  * ``vote`` — plurality vote over the replicas' *argmax token ids*; exact
    whenever >= f+1 honest replicas agree on the top token.

The :class:`DivergenceDetector` watches each replica's distance to the
quorum answer and ejects a persistent outlier, never below the 2f+1 floor.

Under a serve mesh's rule table whose ``logits`` (the vocab) is split over
'model', each rank reads its vocab block: the median runs on the block,
the argmax takes each rank's first maximum and then the first rank with
the largest value (the single card's first-index tie rule), and a
distance sums its squares over every rank's block in rank order.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import agg
from ..models import sharding as shr
from ..models.layers import argmax_vocab

#: read-rule registry names (both live in ``repro_torch.agg``)
READ_RULES = ("median", "vote")


def quorum_logits(logits, f: int, mask=None):
    """Consolidated logits: coordinate-wise median over the replica axis.
    ``logits`` is ``[R, ...]``; ``mask`` (host bool ``[R]``) drops ejected
    replicas with exact delivered-subset semantics."""
    return agg.get("median")(logits, f, mask=mask)


def quorum_tokens(logits, f: int, rule: str = "median", mask=None):
    """One quorum-read step: per-replica logits ``[R, B, V]`` -> next token
    ids ``[B]`` (int32) consolidated by ``rule``."""
    if rule not in READ_RULES:
        raise ValueError(f"unknown quorum read rule {rule!r}; "
                         f"have {READ_RULES}")
    if rule == "median":
        return argmax_vocab(quorum_logits(logits, f, mask=mask)).to(
            torch.int32)
    votes = argmax_vocab(logits).to(torch.int32)             # [R, B]
    return agg.get("vote")(votes, f, mask=mask)


def disagreement(logits, tokens, mask=None) -> float:
    """Fraction of (active replica, slot) argmax votes that differ from the
    committed quorum token — the service's per-read disagreement metric."""
    votes = argmax_vocab(logits).cpu().numpy()               # [R, B]
    toks = np.asarray(tokens)[None, :]
    m = np.ones(votes.shape[0], bool) if mask is None else np.asarray(mask)
    if not m.any():
        return 0.0
    return float((votes[m] != toks).mean())


@dataclass
class DetectorConfig:
    """Envelope test knobs: a replica strikes when its RMS logit distance to
    the quorum answer exceeds ``abs_tol`` AND ``rel`` times the active-set
    median distance; ``patience`` consecutive strikes flag it. A re-admitted
    replica serves ``probation`` reads under a zero-patience rule."""
    patience: int = 3
    rel: float = 4.0
    abs_tol: float = 1e-4
    probation: int = 16


class DivergenceDetector:
    """Flags/ejects replicas whose outputs persistently sit outside the
    quorum envelope. Host-side bookkeeping: :meth:`observe` takes one read's
    per-replica distances plus the active mask and returns the replicas it
    ejected (never taking the active count below ``2f+1``)."""

    def __init__(self, n_replicas: int, f: int,
                 cfg: DetectorConfig | None = None):
        self.n = int(n_replicas)
        self.f = int(f)
        self.cfg = cfg or DetectorConfig()
        self.strikes = np.zeros(self.n, np.int64)
        self.flagged = np.zeros(self.n, bool)
        self.probation = np.zeros(self.n, np.int64)
        self.reads = 0

    @staticmethod
    def distances(logits, answer) -> np.ndarray:
        """Per-replica RMS distance to the quorum answer: [R, ...] vs [...]
        -> [R] (device math, one scalar per replica on the host)."""
        diff = logits.float() - answer.float()[None]
        axes = tuple(range(1, diff.ndim))
        tp = shr.active()
        if tp is None or not tp.split("logits"):
            return torch.sqrt(torch.mean(diff * diff,
                                         dim=axes)).cpu().numpy()
        sq = shr.sum_ranks(tp.mesh, torch.sum(diff * diff, dim=axes),
                           "model")
        return torch.sqrt(sq / (diff[0].numel() * tp.M)).cpu().numpy()

    def observe(self, dist: np.ndarray, active: np.ndarray) -> list[int]:
        """Update strikes from one read's distances; flag on ``patience``
        consecutive strikes; return replicas ejected this read."""
        dist = np.asarray(dist, np.float64)
        active = np.asarray(active, bool)
        self.reads += 1
        envelope = np.median(dist[active]) if active.any() else 0.0
        thresh = max(self.cfg.abs_tol, self.cfg.rel * envelope)
        outlier = active & (dist > thresh)
        self.strikes = np.where(outlier, self.strikes + 1, 0)
        newly = (~self.flagged) & ((self.strikes >= self.cfg.patience)
                                   | (outlier & (self.probation > 0)))
        self.flagged |= newly
        self.probation = np.where(active, np.maximum(self.probation - 1, 0),
                                  self.probation)
        floor = 2 * self.f + 1
        ejected = []
        order = sorted(np.nonzero(newly)[0], key=lambda i: -dist[i])
        n_active = int(active.sum())
        for i in order:
            if n_active - 1 < floor:
                break
            ejected.append(int(i))
            n_active -= 1
        return ejected

    def readmit(self, i: int) -> None:
        """Reset replica i's record and start its probation window."""
        self.strikes[i] = 0
        self.flagged[i] = False
        self.probation[i] = self.cfg.probation


def markdown_table() -> str:
    """The quorum-read table (``python -m repro_torch.serve`` prints it),
    derived from the :mod:`repro_torch.agg` registry specs."""
    rows = [
        ("median", "coordinate-wise median over replica logits, then argmax",
         "exact while <= f of n replicas are corrupt (n >= 2f+1)",
         "one [B, V] logit stack per replica"),
        ("vote", "plurality vote over per-replica argmax token ids",
         "exact while >= f+1 honest replicas agree on the top token",
         "one token id per replica"),
    ]
    out = ["| read rule | consolidation | guarantee | read payload |",
           "|---|---|---|---|"]
    for name, how, guarantee, payload in rows:
        spec = agg.get(name)
        out.append(f"| `{name}` (breakdown {spec.breakdown}) | {how} | "
                   f"{guarantee} | {payload} |")
    out.append("| divergence detector | RMS distance to the quorum answer vs "
               "the active-set envelope | ejects a persistent outlier after "
               "`patience` reads, never below 2f+1 active | — |")
    return "\n".join(out)

"""repro_torch.serve — Byzantine-tolerant replicated inference (port of
``repro.serve``).

    ReplicaPool        — n replicas: broadcast one model / adopt a stack /
                         restore a ByzSGD checkpoint (checkpoint_groups)
    quorum_tokens      — median-of-logits or vote-of-tokens read rules
    DivergenceDetector — flags + ejects persistently-divergent replicas
    ContinuousBatcher  — admission queue + slot refill + deadlines
    QuorumService      — the replicated decode loop with metrics
"""
from .batcher import ContinuousBatcher, Request
from .quorum import (READ_RULES, DetectorConfig, DivergenceDetector,
                     disagreement, quorum_logits, quorum_tokens)
from .replica import ReplicaPool, checkpoint_groups
from .service import QuorumService

__all__ = [
    "ContinuousBatcher", "Request",
    "READ_RULES", "DetectorConfig", "DivergenceDetector",
    "disagreement", "quorum_logits", "quorum_tokens",
    "ReplicaPool", "QuorumService", "checkpoint_groups",
]

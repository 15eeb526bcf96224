"""Model attacks (Byzantine *servers*) of ``repro.core.attacks``: Reversed,
Partial Drop (10% of weights zeroed), Random, LIE (z = 1.035, paper Fig. 5).

Every attack maps the *honest* stack ``[h, ...]`` to one Byzantine payload.
The stochastic ones (``random``, ``partial_drop``) draw from a
``torch.Generator`` that lives on the stack's device; the tests hand both
packages the same numpy draws instead of comparing two generators.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


def _honest_mean(honest):
    return torch.mean(honest, dim=0, dtype=torch.float32)


def reversed_attack(honest, gen, *, scale: float = 1.0):
    """Send -scale * mean(honest): the classic divergence attack."""
    del gen
    return -scale * _honest_mean(honest)


def random_attack(honest, gen, *, scale: float | None = None):
    """Gaussian noise matched (by default) to the honest norm."""
    m = _honest_mean(honest)
    s = (torch.linalg.vector_norm(m) / m.numel() ** 0.5
         if scale is None else scale)
    noise = torch.randn(m.shape, generator=gen, dtype=torch.float32,
                        device=m.device)
    return s * noise


def partial_drop_attack(honest, gen, *, drop: float = 0.1):
    """Zero a random ``drop`` fraction of coordinates."""
    m = _honest_mean(honest)
    keep = torch.rand(m.shape, generator=gen, device=m.device) < 1.0 - drop
    return m * keep


def lie_attack(honest, gen, *, z: float = 1.035):
    """Server LIE: multiply each weight by z with |z-1| ~ 0."""
    del gen
    return z * _honest_mean(honest)


MODEL_ATTACKS: dict[str, Callable] = {
    "reversed": reversed_attack,
    "partial_drop": partial_drop_attack,
    "random": random_attack,
    "lie": lie_attack,
}


@dataclass(frozen=True)
class ByzantineSpec:
    """Which slices are Byzantine and how they attack.

    ``n_byz_workers``/``n_byz_servers`` actual adversaries (<= declared f).
    Server indices ``[n_ps - n_byz_s, n_ps)`` are Byzantine (w.l.o.g., as in
    the paper's notation §B.1). The worker fields are kept for the spec's
    shape; the gradient attacks arrive with the training slice.
    """
    worker_attack: str | None = None
    server_attack: str | None = None
    n_byz_workers: int = 0
    n_byz_servers: int = 0
    equivocate: bool = False
    attack_kwargs: tuple = ()  # extra (name, value) pairs, hashable

    def kwargs(self) -> dict:
        return dict(self.attack_kwargs)


def _inject_stack(stack, fn, kw: dict, n_byz: int, gen):
    """One leaf ``[n, ...]`` -> ``[n, ...]`` with its last ``n_byz`` rows
    replaced by one payload each (the JAX ``vmap`` over payload keys, as a
    loop). A new tensor: the input, which may be a broadcast view shared by
    every replica, is never written."""
    h = stack.shape[0] - n_byz
    honest = stack[:h]
    payloads = [fn(honest, gen, **kw).to(stack.dtype) for _ in range(n_byz)]
    return torch.cat([honest, torch.stack(payloads)], dim=0)


def inject_models(models, spec: ByzantineSpec, gen: torch.Generator | None):
    """Replace the last ``n_byz_servers`` entries of every ``[n_ps, ...]``
    leaf of a nested dict of server parameter stacks by the spec's attack
    (leaf by leaf: every attack is coordinate-wise, except random's
    norm-matched scale, which becomes per-leaf, as in the JAX package)."""
    attack, n_byz = spec.server_attack, spec.n_byz_servers
    if not attack or n_byz == 0:
        return models
    fn, kw = MODEL_ATTACKS[attack], spec.kwargs()

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return _inject_stack(tree, fn, kw, n_byz, gen)

    return walk(models)

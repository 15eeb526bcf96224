"""Byzantine attack library of ``repro.core.attacks``.

Gradient attacks (Byzantine *workers*): reversed, random, ALIE ("a little is
enough", Baruch et al. 2019 — the paper's headline worker attack), sign flip,
zero. Model attacks (Byzantine *servers*): Reversed, Partial Drop (10% of
weights zeroed), Random, LIE (z = 1.035, paper Fig. 5).

Every attack maps the *honest* stack ``[h, ...]`` to one Byzantine payload.
With ``n_receivers`` (equivocation) every receiver gets its own payloads,
``[n_recv, n, ...]``. The stochastic attacks (``random``, ``partial_drop``)
draw from a ``torch.Generator`` on the stack's device; the tests hand both
packages the same numpy draws instead of comparing two generators.

A stack is a tensor ``[n, D]`` — the port's flat model layout — or a nested
dict of ``[n, ...]`` leaves. Every attack is coordinate-wise except random's
norm-matched scale, which the JAX package takes per leaf; on a flat stack
pass the model's :class:`~repro_torch.core.simulator.FlatTree` as ``tree``
and random works leaf by leaf over its views.
"""
from __future__ import annotations

from dataclasses import dataclass
from statistics import NormalDist
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


def sign_flip_attack(honest, gen, *, scale: float = 1.0):
    del gen
    return (-scale * torch.sign(_honest_mean(honest))
            * torch.mean(torch.abs(honest), dim=0, dtype=torch.float32))


def zero_attack(honest, gen):
    del gen
    return torch.zeros(honest.shape[1:], dtype=honest.dtype,
                       device=honest.device)


def alie_zmax(n: int, f: int) -> float:
    """ALIE amplitude: z s.t. the shifted vector still looks like a majority
    member, phi^-1((n - floor(n/2+1)) / (n - f)) per Baruch et al. 2019."""
    s = (n // 2) + 1 - f
    frac = (n - f - s) / (n - f)
    frac = min(max(frac, 1e-6), 1 - 1e-6)
    return float(NormalDist().inv_cdf(frac))


def alie_attack(honest, gen, *, n: int, f: int, z: float | None = None):
    """A-Little-Is-Enough: mean + z_max * per-coordinate std (ddof 0, as
    ``jnp.std``) of the honest inputs."""
    del gen
    zv = alie_zmax(n, f) if z is None else z
    mu = _honest_mean(honest)
    sd = torch.std(honest.float(), dim=0, correction=0)
    return mu + zv * sd


GRADIENT_ATTACKS: dict[str, Callable] = {
    "reversed": reversed_attack,
    "random": random_attack,
    "alie": alie_attack,
    "sign_flip": sign_flip_attack,
    "zero": zero_attack,
}

MODEL_ATTACKS: dict[str, Callable] = {
    "reversed": reversed_attack,
    "partial_drop": partial_drop_attack,
    "random": random_attack,
    "lie": lie_attack,
}

# attacks that draw from the generator: one draw per payload
_STOCHASTIC = (random_attack, partial_drop_attack)


@dataclass(frozen=True)
class ByzantineSpec:
    """Which slices are Byzantine and how they attack.

    ``n_byz_workers``/``n_byz_servers`` actual adversaries (<= declared f).
    Worker indices ``[n_w - n_byz_w, n_w)`` and server indices
    ``[n_ps - n_byz_s, n_ps)`` are Byzantine (w.l.o.g., as in the paper's
    notation §B.1).
    """
    worker_attack: str | None = None
    server_attack: str | None = None
    n_byz_workers: int = 0
    n_byz_servers: int = 0
    equivocate: bool = False  # per-destination payloads
    attack_kwargs: tuple = ()  # extra (name, value) pairs, hashable

    def kwargs(self) -> dict:
        return dict(self.attack_kwargs)

    @property
    def equivocates_models(self) -> bool:
        return bool(self.equivocate and self.server_attack
                    and self.n_byz_servers)

    @property
    def equivocates_grads(self) -> bool:
        return bool(self.equivocate and self.worker_attack
                    and self.n_byz_workers)


def _payloads(honest, fn, kw: dict, count: int, gen, tree):
    """``count`` payloads ``[count, ...]``: one draw each for a stochastic
    attack, one payload broadcast for a deterministic one; random's scale
    leaf by leaf when a flat stack's ``tree`` is given."""
    def one():
        if tree is not None and fn is random_attack:
            return torch.cat([fn(honest[:, off:off + size], gen, **kw)
                              for off, size in tree.spans()], dim=-1)
        return fn(honest, gen, **kw)

    if fn in _STOCHASTIC:
        return torch.stack([one() for _ in range(count)])
    p = one()
    return p.expand((count,) + p.shape)


def _inject_stack(stack, fn, kw: dict, n_byz: int, gen, n_receivers,
                  tree=None, inplace: bool = False):
    """One stack ``[n, ...]`` -> ``[n, ...]`` (or ``[n_recv, n, ...]``) with
    its last ``n_byz`` rows replaced by payloads. A new tensor — the input,
    which may be a broadcast view shared by every replica, is never written
    — unless ``inplace``, where the payloads overwrite the stack's own last
    rows (a stack the caller owns, too large to copy)."""
    n = stack.shape[0]
    h = n - n_byz
    honest = stack[:h]
    if fn is alie_attack:
        kw = {"n": n, "f": n_byz, **kw}
    if n_receivers is None:
        pl = _payloads(honest, fn, kw, n_byz, gen, tree).to(stack.dtype)
        if inplace:
            stack[h:] = pl
            return stack
        return torch.cat([honest, pl], dim=0)
    pl = _payloads(honest, fn, kw, n_receivers * n_byz, gen, tree)
    pl = pl.reshape((n_receivers, n_byz) + honest.shape[1:]).to(stack.dtype)
    return torch.cat([honest.expand((n_receivers,) + honest.shape), pl],
                     dim=1)


def _inject(stacks, attack, registry, kw, n_byz, gen, n_receivers, tree,
            inplace=False):
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if not attack or n_byz == 0:
            if n_receivers is None:
                return t
            return t.expand((n_receivers,) + t.shape)
        return _inject_stack(t, registry[attack], kw, n_byz, gen,
                             n_receivers, tree, inplace)

    return walk(stacks)


def inject_gradients(grads, spec: ByzantineSpec, gen, n_receivers=None,
                     tree=None, inplace: bool = False):
    """Replace the last ``n_byz_workers`` entries of the ``[n_w, ...]``
    gradient stack. With ``n_receivers`` (equivocation) returns
    ``[n_recv, n_w, ...]``; with ``inplace`` (no equivocation) the payloads
    overwrite the given stack's rows."""
    return _inject(grads, spec.worker_attack, GRADIENT_ATTACKS,
                   spec.kwargs(), spec.n_byz_workers, gen, n_receivers, tree,
                   inplace)


def inject_models(models, spec: ByzantineSpec, gen, n_receivers=None,
                  tree=None):
    """Same for server parameter stacks ``[n_ps, ...]``."""
    return _inject(models, spec.server_attack, MODEL_ATTACKS,
                   spec.kwargs(), spec.n_byz_servers, gen, n_receivers, tree)

"""Learning-rate schedules of ``repro.optim.schedules`` (the paper's
conditions B.1: monotone decreasing, sum eta = inf, sum eta^2 < inf).

Each schedule returns ``lr(t)`` as a Python float holding the float32 value
the JAX package computes in float32 at step t, so an update ``p - eta * g``
scales by the same number in both packages.
"""
from __future__ import annotations

import numpy as np

_F = np.float32


def inverse_sqrt(eta0: float = 0.1, warmup: int = 0, offset: float = 1.0):
    def lr(t):
        base = _F(eta0) / np.sqrt(_F(offset) + _F(t))
        if warmup > 0:
            base = base * np.minimum(_F(1.0), (_F(t) + _F(1)) / _F(warmup))
        return float(_F(base))
    return lr


def inverse_linear(eta0: float = 0.1, decay: float = 0.01):
    # eta_t = eta0 / (1 + decay * t): sum eta ~ log t diverges, sum eta^2
    # converges — condition B.1
    def lr(t):
        return float(_F(eta0) / (_F(1.0) + _F(decay) * _F(t)))
    return lr


def constant(eta0: float = 0.01):
    """For throughput benchmarks only (violates sum eta_t^2 < inf)."""
    def lr(t):
        del t
        return float(_F(eta0))
    return lr

"""Deterministic synthetic data — the mixture part of
``repro.data.pipeline``.

The paper trains MNIST/CIFAR-10; neither dataset is vendored, so the
experiments use a synthetic Gaussian-mixture classification task with
controllable difficulty (i.i.d. across workers; mini-batch noise scaling as
1/sqrt(b)). Batches are drawn on the device from a ``torch.Generator``: the
numbers differ from the JAX package's ``jax.random`` draws, so the parity
tests hand both packages the same numpy batches. The token streams of the
LM models arrive with the model-zoo slice; :class:`TokenSpec` is here so the
experiment registry keeps its entries.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class MixtureSpec:
    n_classes: int = 10
    dim: int = 64
    sep: float = 2.5      # class-centre separation (controls difficulty)
    noise: float = 1.0


@dataclass(frozen=True)
class TokenSpec:
    """Synthetic LM data spec (Zipf-distributed tokens); its streams are not
    ported yet."""
    vocab: int = 512
    seq: int = 64
    zipf: float = 1.2


def make_mixture(spec: MixtureSpec, gen: torch.Generator) -> torch.Tensor:
    """Class centres ``[n_classes, dim]`` on the generator's device."""
    return spec.sep * torch.randn((spec.n_classes, spec.dim), generator=gen,
                                  device=gen.device)


def sample_classification_batch(gen: torch.Generator, centres, spec:
                                MixtureSpec, n_workers: int,
                                batch_per_worker: int):
    """``(x [n_w, b, dim], y [n_w, b])`` — i.i.d. across workers."""
    shape = (n_workers, batch_per_worker)
    y = torch.randint(0, spec.n_classes, shape, generator=gen,
                      device=gen.device)
    noise = spec.noise * torch.randn(shape + (spec.dim,), generator=gen,
                                     device=gen.device)
    return centres[y] + noise, y


class DeviceBatchStream:
    """Per-worker batches drawn on the device: ``next(L)`` returns the next
    L steps as ``(x [L, n_w, b, dim], y [L, n_w, b])``. The draws go step by
    step, so successive ``next`` calls of any lengths give the same sequence
    (the fused runner's epochs equal the stepwise runner's steps)."""

    def __init__(self, seed: int, spec: MixtureSpec, n_workers: int,
                 batch_per_worker: int, device=None):
        device = torch.device("cpu" if device is None else device)
        self.spec = spec
        self.n_workers = n_workers
        self.batch_per_worker = batch_per_worker
        self.device = device
        self.centres = make_mixture(
            spec, torch.Generator(device=device).manual_seed(seed))
        self._gen = torch.Generator(device=device).manual_seed(seed + 1)

    def next(self, length: int):
        xs, ys = zip(*(sample_classification_batch(
            self._gen, self.centres, self.spec, self.n_workers,
            self.batch_per_worker) for _ in range(length)))
        return torch.stack(xs), torch.stack(ys)

    def eval_set(self, n: int = 2048, eval_seed: int = 10_007):
        """Held-out eval set ``(x [n, dim], y [n])`` from its own seed."""
        gen = torch.Generator(device=self.device).manual_seed(eval_seed)
        x, y = sample_classification_batch(gen, self.centres, self.spec, 1, n)
        return x[0], y[0]


def classification_stream(seed: int, spec: MixtureSpec, n_workers: int,
                          batch_per_worker: int, steps: int, device=None):
    """A generator of per-step batches ``(x [n_w, b, dim], y [n_w, b])`` —
    the same sequence as :class:`DeviceBatchStream` — and the eval-set
    maker."""
    stream = DeviceBatchStream(seed, spec, n_workers, batch_per_worker,
                               device)

    def gen():
        for _ in range(steps):
            x, y = stream.next(1)
            yield x[0], y[0]

    return gen(), stream.eval_set

"""Deterministic synthetic data — the port of ``repro.data.pipeline``.

The paper trains MNIST/CIFAR-10; neither dataset is vendored, so the
experiments use a synthetic Gaussian-mixture classification task with
controllable difficulty (i.i.d. across workers; mini-batch noise scaling as
1/sqrt(b)), and the LM models a Zipf-distributed next-token task. Batches
are drawn on the device from a ``torch.Generator``: the numbers differ from
the JAX package's ``jax.random`` draws (the law is the same), so the parity
tests hand both packages the same numpy batches.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import resolve


@dataclass(frozen=True)
class MixtureSpec:
    n_classes: int = 10
    dim: int = 64
    sep: float = 2.5      # class-centre separation (controls difficulty)
    noise: float = 1.0


@dataclass(frozen=True)
class TokenSpec:
    """Synthetic LM data spec (the token analogue of :class:`MixtureSpec`).

    Zipf-distributed tokens (``zipf > 0``) keep the unigram statistics
    learnable — uniform tokens pin the cross-entropy at ``ln vocab`` and no
    training signal exists; ``zipf = 0`` gives uniform tokens."""
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


def _width(launch: int, n_workers: int | None) -> int:
    nw = launch if n_workers is None else n_workers
    if not 1 <= nw <= launch:
        raise ValueError(f"a stream launched {launch} workers wide draws "
                         f"1..{launch} of them per step; got {nw}")
    return nw


class DeviceBatchStream:
    """Per-worker batches drawn on the device: ``next(L)`` returns the next
    L steps as ``(x [L, n_w, b, dim], y [L, n_w, b])``. The draws go step by
    step, so successive ``next`` calls of any lengths give the same sequence
    (the fused runner's epochs equal the stepwise runner's steps)."""

    def __init__(self, seed: int, spec: MixtureSpec, n_workers: int,
                 batch_per_worker: int, device=None):
        device = resolve(device)
        self.spec = spec
        self.n_workers = n_workers
        self.batch_per_worker = batch_per_worker
        self.device = device
        self.centres = make_mixture(
            spec, torch.Generator(device=device).manual_seed(seed))
        self._gen = torch.Generator(device=device).manual_seed(seed + 1)

    def next(self, length: int, n_workers: int | None = None):
        """The next ``length`` steps, ``n_workers`` wide (default: the
        stream's width). Every step draws at the stream's width and keeps
        its first ``n_workers`` rows: a torch generator's draws grow with
        the width, so a narrower draw while the elastic runner's fleet is
        shrunk would shift every later batch away from the full-width
        run's."""
        nw = _width(self.n_workers, n_workers)
        xs, ys = zip(*(sample_classification_batch(
            self._gen, self.centres, self.spec, self.n_workers,
            self.batch_per_worker) for _ in range(length)))
        return torch.stack(xs)[:, :nw], torch.stack(ys)[:, :nw]

    def skip(self, length: int) -> None:
        """Advance ``length`` steps: :meth:`next` with the result dropped
        (a checkpointed run's resume)."""
        if length:
            self.next(length)

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


# ---------------------------------------------------------------------------
# LM tokens
# ---------------------------------------------------------------------------

def _token_cdf(vocab: int, zipf: float, device) -> torch.Tensor:
    """float64 CDF of the categorical law with logits ``-zipf * log(rank)``
    over ranks 1..vocab (token id = rank - 1), the JAX package's law."""
    logits = -zipf * torch.log(torch.arange(1, vocab + 1, dtype=torch.float64,
                                            device=device))
    cdf = torch.cumsum(torch.softmax(logits, dim=0), dim=0)
    cdf[-1] = 1.0
    return cdf


def _draw_tokens(gen: torch.Generator, vocab: int, zipf: float, shape,
                 cdf=None) -> torch.Tensor:
    """int64 tokens of ``shape``: Zipf by inverse-CDF sampling (``zipf >
    0``), uniform otherwise."""
    if zipf > 0:
        cdf = _token_cdf(vocab, zipf, gen.device) if cdf is None else cdf
        u = torch.rand(shape, generator=gen, dtype=torch.float64,
                       device=gen.device)
        return torch.clamp(torch.searchsorted(cdf, u, right=True),
                           max=vocab - 1)
    return torch.randint(0, vocab, shape, generator=gen, device=gen.device)


def sample_token_batch(gen: torch.Generator, spec: TokenSpec, n_workers: int,
                       batch_per_worker: int, cdf=None) -> dict:
    """One next-token batch: dict(tokens, labels), leaves ``[n_w, b, seq]``
    (labels are the tokens shifted by one)."""
    toks = _draw_tokens(gen, spec.vocab, spec.zipf,
                        (n_workers, batch_per_worker, spec.seq + 1), cdf)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


class DeviceTokenStream:
    """Token batches drawn on the device, with the
    :class:`DeviceBatchStream` interface: ``next(L)`` returns the next L
    steps as dict(tokens, labels) of ``[L, n_w, b, seq]`` leaves. The draws
    go step by step, so successive ``next`` calls of any lengths give the
    same sequence as :func:`token_stream` with the same seed."""

    def __init__(self, seed: int, spec: TokenSpec, n_workers: int,
                 batch_per_worker: int, device=None):
        device = resolve(device)
        self.spec = spec
        self.n_workers = n_workers
        self.batch_per_worker = batch_per_worker
        self.device = device
        self._gen = torch.Generator(device=device).manual_seed(seed)
        self._cdf = (_token_cdf(spec.vocab, spec.zipf, device)
                     if spec.zipf > 0 else None)

    def next(self, length: int, n_workers: int | None = None) -> dict:
        """The next ``length`` steps, ``n_workers`` wide, drawn at the
        stream's width as :meth:`DeviceBatchStream.next` does."""
        nw = _width(self.n_workers, n_workers)
        bs = [sample_token_batch(self._gen, self.spec, self.n_workers,
                                 self.batch_per_worker, self._cdf)
              for _ in range(length)]
        return {k: torch.stack([b[k] for b in bs])[:, :nw] for k in bs[0]}

    def skip(self, length: int) -> None:
        """Advance ``length`` steps: :meth:`next` with the result dropped."""
        if length:
            self.next(length)

    def eval_set(self, n: int = 256, eval_seed: int = 10_007):
        """Held-out eval batch ``(tokens [n, seq], labels [n, seq])`` from
        its own seed."""
        gen = torch.Generator(device=self.device).manual_seed(eval_seed)
        b = sample_token_batch(gen, self.spec, 1, n, self._cdf)
        return b["tokens"][0], b["labels"][0]


def token_stream(seed: int, vocab: int, n_workers: int, batch_per_worker: int,
                 seq_len: int, steps: int, zipf: float = 1.2, device=None):
    """Deterministic LM token batches: dict(tokens, labels) with leaves
    ``[n_w, b, seq_len]``, labels next-token shifted — the sequence of
    :class:`DeviceTokenStream` with the same seed."""
    stream = DeviceTokenStream(seed, TokenSpec(vocab, seq_len, zipf),
                               n_workers, batch_per_worker, device)
    for _ in range(steps):
        b = stream.next(1)
        yield {k: v[0] for k, v in b.items()}

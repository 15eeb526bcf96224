"""The benchmark's inputs, made from ``--seed`` alone and handed alike to
the program and to the reference: the initial model, each step's token
batch, and the quorum tables the protocol's deliveries replay.

Each input draws from its own stream, seeded from the run's seed and the
input's name (:func:`stream_seed`), so a seed of any size gives the same
inputs every time, and one input's draws never shift another's.
"""
from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from .reference import protocol as ref


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed of the input stream ``name`` of the run ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def make_weights(c: dict, seed: int, device) -> torch.Tensor:
    """The initial model, flat ``[P]`` float32 on ``device`` in the leaf
    order of :func:`bench.reference.protocol.spans`: one normal draw over
    every parameter, then each leaf shaped to its law in place (clipped and
    scaled, filled, or drawn uniform)."""
    gen = torch.Generator(device=device).manual_seed(
        stream_seed(seed, "weights"))
    sp = ref.spans(c)
    flat = torch.randn(sum(n for *_, n in sp), generator=gen, device=device)
    laws = {path: law for path, _, law, _ in ref.family(c).leaf_table(c)}
    for path, _, o, n in sp:
        kind, arg = laws[path]
        v = flat[o:o + n]
        if kind == "clipped":
            v.clamp_(-2.0, 2.0).mul_(arg)
        elif kind == "normal":
            v.mul_(arg)
        elif kind == "const":
            v.fill_(arg)
        elif kind == "uniform":
            v.uniform_(0.0, arg, generator=gen)
        else:
            raise ValueError(f"{path}: unknown init law {kind!r}")
    return flat


def zipf_cdf(vocab: int, zipf: float, device) -> torch.Tensor:
    """float64 CDF of token ids 0..vocab-1 with probability proportional
    to ``(id + 1) ** -zipf``."""
    logits = -zipf * torch.log(torch.arange(1, vocab + 1, dtype=torch.float64,
                                            device=device))
    cdf = torch.cumsum(torch.softmax(logits, dim=0), dim=0)
    cdf[-1] = 1.0
    return cdf


class TokenFeed:
    """Each step's batch, drawn on the device: ``next()`` gives ``tokens``
    and ``labels`` ``[G, B, S]`` int64, the labels the tokens shifted by
    one, every id drawn from the Zipf law by its inverse CDF."""

    def __init__(self, seed: int, vocab: int, traffic: dict, device):
        self.shape = (traffic["groups"], traffic["batch_per_group"],
                      traffic["seq"] + 1)
        self.vocab = vocab
        self.gen = torch.Generator(device=device).manual_seed(
            stream_seed(seed, "tokens"))
        self.cdf = zipf_cdf(vocab, traffic["zipf"], device)

    def next(self) -> dict:
        u = torch.rand(self.shape, generator=self.gen, dtype=torch.float64,
                       device=self.cdf.device)
        ids = torch.clamp(torch.searchsorted(self.cdf, u, right=True),
                          max=self.vocab - 1)
        return {"tokens": ids[..., :-1], "labels": ids[..., 1:]}


def quorum_tables(seed: int, traffic: dict) -> dict:
    """Int64 tables of who delivers to whom, ``traffic["table_steps"]``
    steps long (replayed modulo their length): ``pull [steps, G, q_ps]``
    server replicas each worker's pull delivers, ``push [steps, G, q_w]``
    gradients each server's push delivers, ``gather [steps // T, G,
    q_ps]`` replicas each server's gather delivers, its own first. Each
    row is a uniform draw of distinct senders."""
    rng = np.random.default_rng(stream_seed(seed, "quorums"))
    G, T, n = traffic["groups"], traffic["T"], traffic["table_steps"]
    q_w = G - traffic["f_workers"]
    q_ps = G - traffic["f_servers"]

    def draw(rows, q):
        return np.stack([[rng.permutation(G)[:q] for _ in range(G)]
                         for _ in range(rows)])

    gather = np.stack([[np.concatenate([[s], rng.permutation(
        np.delete(np.arange(G), s))[:q_ps - 1]]) for s in range(G)]
        for _ in range(max(1, n // T))])
    return {"pull": draw(n, q_ps), "push": draw(n, q_w),
            "gather": gather.astype(np.int64)}


def tokens_per_step(traffic: dict) -> int:
    return traffic["groups"] * traffic["batch_per_group"] * traffic["seq"]


def check_steps(traffic: dict) -> int:
    """The steps the comparison follows: from counter ``t0`` to the first
    DMC gather, so that the last of them gathers."""
    return math.ceil((traffic["t0"] + 1) / traffic["T"]) * traffic["T"] \
        - traffic["t0"]

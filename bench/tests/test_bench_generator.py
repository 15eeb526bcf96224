"""The inputs repeat from a seed, of any size, and keep their laws."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench import inputs, spec
from bench.reference import protocol as ref

from conftest import TINY

MIX = spec.read_json(spec.BENCH / "traffic" / "g4-alie-1k.json") | {
    "seq": 16}
BIG = 2**31 + 12345


def test_stream_seeds_differ_by_name_and_seed():
    seeds = {inputs.stream_seed(s, n) for s in (0, 1, BIG, 2**40)
             for n in ("weights", "tokens", "quorums")}
    assert len(seeds) == 12 and all(0 <= s < 2**63 for s in seeds)


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_tokens_repeat(seed):
    a = inputs.TokenFeed(seed, 512, MIX, "cpu")
    b = inputs.TokenFeed(seed, 512, MIX, "cpu")
    for _ in range(3):
        x, y = a.next(), b.next()
        assert torch.equal(x["tokens"], y["tokens"])
    other = inputs.TokenFeed(seed + 1, 512, MIX, "cpu").next()
    assert not torch.equal(other["tokens"], x["tokens"])
    assert x["tokens"].shape == (4, 4, 16)
    assert torch.equal(x["tokens"][..., 1:], x["labels"][..., :-1])
    assert 0 <= int(x["tokens"].min()) and int(x["tokens"].max()) < 512


def test_tokens_follow_zipf():
    feed = inputs.TokenFeed(3, 512, MIX | {"seq": 4096}, "cpu")
    ids = feed.next()["tokens"].flatten()
    counts = torch.bincount(ids, minlength=512).double()
    # rank 1 against rank 2: (2 / 1) ** 1.2 = 2.30
    assert 2.0 < float(counts[0] / counts[1]) < 2.6


@pytest.mark.parametrize("seed", [1, BIG])
def test_quorum_tables_repeat(seed):
    a, b = inputs.quorum_tables(seed, MIX), inputs.quorum_tables(seed, MIX)
    for k in ("pull", "push", "gather"):
        assert np.array_equal(a[k], b[k])
    G = MIX["groups"]
    assert a["pull"].shape == (64, G, G) and a["push"].shape == (64, G, G - 1)
    assert a["gather"].shape == (64 // MIX["T"], G, G)
    for row in a["push"].reshape(-1, G - 1):
        assert len(set(row.tolist())) == G - 1
    assert np.array_equal(a["gather"][:, :, 0],
                          np.broadcast_to(np.arange(G), (12, G)))
    c = inputs.quorum_tables(seed + 1, MIX)
    assert not np.array_equal(a["push"], c["push"])


@pytest.mark.parametrize("name", sorted(TINY))
def test_weights_repeat_and_keep_their_laws(name):
    c = TINY[name]
    a, b = (inputs.make_weights(c, BIG, "cpu") for _ in range(2))
    assert torch.equal(a, b)
    assert not torch.equal(a, inputs.make_weights(c, BIG + 1, "cpu"))
    laws = {p: law for p, _, law, _ in ref.family(c).leaf_table(c)}
    for path, shape, o, n in ref.spans(c):
        v = a[o:o + n]
        kind, arg = laws[path]
        if kind == "const":
            assert bool((v == arg).all()), path
        elif kind == "uniform":
            assert 0 <= float(v.min()) and float(v.max()) < arg
        elif kind == "clipped":
            assert float(v.abs().max()) <= 2 * arg * (1 + 1e-6)
            # a normal clipped at 2 deviations keeps 0.96 of its deviation
            assert 0.92 * arg < float(v.std()) < 1.0 * arg, path
        else:
            assert 0.9 * arg < float(v.std()) < 1.1 * arg, path


def test_check_steps_end_in_the_gather():
    for t0, T, want in ((2, 5, 3), (0, 5, 5), (4, 5, 1), (5, 5, 5)):
        n = inputs.check_steps({"t0": t0, "T": T})
        assert n == want and (t0 + n) % T == 0

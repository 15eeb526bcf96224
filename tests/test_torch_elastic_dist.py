"""The port's elastic membership over ``torch.distributed`` ranks: gloo
ranks on the CPU, spawned once per world (W = 8 and W = 5) by
``tests/_torch_elastic_runner.py``, which imports no JAX.

``elastic/planned_churn`` (G 5 -> 4 at step 8 -> 5 at step 16, 24 steps)
runs over the ranks on the replay of ``tests/test_torch_membership.py``
(the quorum tables of each fleet size, numpy batches, one initial state),
held to JAX's one-device elastic run and to the port's one-rank run on the
same replay; and as registered (its own generator and batch stream), held
to the port's one-rank run, uninterrupted, with ``ckpt_every=4``, and
killed after step 12 and resumed. Each segment runs on the reference's mesh
for its fleet on the world's first ranks (``launch.mesh.segment_ranks``),
the others idle; at each boundary the stacks are re-formed across the
ranks (``membership.reform_state``). The reference's own multi-device lane
(``tests/test_elastic_distributed.py``) is not a gate here."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.exp as jexp
import repro_torch.exp as exp
from repro.core import protocol as jproto
from repro_torch.core import membership as tmem
from repro_torch.core import protocol as tproto
from repro_torch.models.convert import protocol_state_from_jax
from test_torch_membership import _patch, _Replay

ROOT = Path(__file__).resolve().parents[1]
PRESET = "elastic/planned_churn"
WORLDS = (8, 5)
# each world's segment meshes: the reference's (rep, fsdp, 1) for G = 5,
# 4, 5 on the first rep * fsdp ranks
MESHES = {8: [(5, 1, 1), (4, 2, 1), (5, 1, 1)],
          5: [(5, 1, 1), (4, 1, 1), (5, 1, 1)]}
RUNS = {8: ("replay", "sgd", "sgd_ckpt", "sgd_resumed", "adamw",
            "adamw_ckpt", "adamw_resumed"),
        5: ("replay", "sgd", "sgd_ckpt", "sgd_resumed")}
# item 9's bounds: ranks against one device, float32 summation order
REL_L2, REL_MAX = 1e-5, 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's one-device elastic run and the port's one-rank run on the
    replay, the port's one-rank runs as registered, and the ranks'
    records."""
    d = tmp_path_factory.mktemp("elastic_dist")
    e = jexp.get(PRESET)
    replay = _Replay(e)
    j0 = jax.tree.map(np.asarray, jproto.make_init_fn(
        jproto.ProblemBundle(*e.build_problem()[:2]),
        e.to_protocol_config())(jax.random.PRNGKey(e.seed)))
    with pytest.MonkeyPatch.context() as mp:
        sel = _patch(mp, replay, j0)
        jres = jexp.run(e)
        one = exp.run(PRESET, device="cpu")
    want = protocol_state_from_jax(jax.tree.map(np.asarray, jres.state),
                                   "cpu")
    tables = {}
    for (G, qw, qps), (pull, push, gather) in replay.tables.items():
        key = f"{G}_{qw}_{qps}"
        tables.update({f"pull_{key}": pull, f"push_{key}": push,
                       f"gather_{key}": gather})
    np.savez(d / "inputs.npz", x=replay.x, y=replay.y, ex=replay.ex,
             ey=replay.ey,
             params0=protocol_state_from_jax(j0, "cpu").params.numpy(),
             **tables)
    ref = {"jax": (want.params.numpy(), sel["jax"]),
           "one_replay": (one.state.params.numpy(), sel["port"])}
    for opt in ("sgd", "adamw"):
        picked, qw = [], tproto.quorum_weights

        def record(*a):
            w = qw(*a)
            picked.append(w.numpy().copy())
            return w

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tproto, "quorum_weights", record)
            res = exp.run(PRESET, device="cpu", optimizer=opt)
        ref[f"one_{opt}"] = (res.state.params.numpy(), picked)
        ref[f"one_{opt}_res"] = res
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable,
                          str(ROOT / "tests" / "_torch_elastic_runner.py"),
                          str(d)], env=env, capture_output=True, text=True,
                         timeout=300)
    print(out.stdout)
    print(f"[elastic-dist] the ranks' subprocess: "
          f"{time.perf_counter() - t0:.1f} s")
    assert out.returncode == 0 and "TORCH_ELASTIC_RUNNER_DONE" in \
        out.stdout, out.stdout[-3000:] + out.stderr[-6000:]
    return d, ref


def _load(d: Path, world: int, run: str):
    """Per rank: (json record, npz arrays) of one run."""
    out = []
    for r in range(world):
        with open(d / f"w{world}_{run}_{r}.json") as fh:
            rec = json.load(fh)
        out.append((rec, np.load(d / f"w{world}_{run}_{r}.npz")))
    return out


def _sel(arrays) -> list:
    return [arrays[f"sel{i}"] for i in range(sum(
        k.startswith("sel") for k in arrays.files))]


def _errors(got, want, tree_spans):
    """Worst per-leaf relative L2 and relative max."""
    l2 = mx = 0.0
    for off, size in tree_spans:
        a, b = got[:, off:off + size], want[:, off:off + size]
        l2 = max(l2, np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))
        mx = max(mx, np.abs(a - b).max() / (np.abs(b).max() + 1e-12))
    return l2, mx


def _spans():
    e = exp.get(PRESET)
    from repro_torch.core.simulator import FlatTree
    return FlatTree.from_params(e.build_bundle().init(
        torch.Generator())).spans()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("run", ["replay", "sgd"])
def test_segment_meshes_and_idle_ranks(runs, world, run):
    """Three segments with active sets [5, 4, 5] on the reference's meshes
    (W = 8: (5,1,1), (4,2,1), (5,1,1); W = 5: (5,1,1), (4,1,1), (5,1,1));
    a rank past a segment's mesh is idle: at the run's end it holds no
    block ([G, 0]) if the last mesh leaves it out, and inside each segment
    it leaves out it sends 0 bytes."""
    d, _ = runs
    for r, (rec, _) in enumerate(_load(d, world, run)):
        epochs = rec["provenance"]["membership"]["epochs"]
        assert [len(ep["active"]) for ep in epochs] == [5, 4, 5]
        sizes = [tuple(s.values()) for s, _ in rec["segments"]]
        assert sizes == MESHES[world], (r, sizes)
        used = [int(np.prod(s)) for s in MESHES[world]]
        assert [m for _, m in rec["segments"]] == [r < u for u in used]
        assert rec["provenance"]["mesh"] == dict(
            zip(("rep", "fsdp", "model"), MESHES[world][-1]))
        for u, sent in zip(used, rec["segment_sent"]):
            if r >= u:
                assert sent == 0, (r, rec["segment_sent"])
        if r >= used[-1]:
            assert rec["block"] == [5, 0]
        else:
            assert rec["block"][0] == 1 and rec["block"][1] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_replay_matches_jax_and_one_rank(runs, world):
    """On the replay every step's MDA selection equals JAX's one-device
    elastic run's (and the port's one-rank run's): the same support,
    weights within 1e-6; the final params, gathered whole, within item
    9's bounds of both."""
    d, ref = runs
    ranks = _load(d, world, "replay")
    picked = _sel(ranks[0][1])
    spans = _spans()
    for name in ("jax", "one_replay"):
        params, sel = ref[name]
        assert len(picked) == len(sel) == 24
        for t, (a, b) in enumerate(zip(sel, picked)):
            np.testing.assert_array_equal(a > 0, b > 0, err_msg=f"step {t}")
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6,
                                       err_msg=f"step {t}")
        l2, mx = _errors(ranks[0][1]["params"], params, spans)
        print(f"W = {world} against {name}: rel-L2 {l2:.2e}, rel-max "
              f"{mx:.2e}")
        assert l2 < REL_L2 and mx < REL_MAX


@pytest.mark.parametrize("world,opt", [(8, "sgd"), (8, "adamw"),
                                       (5, "sgd")])
def test_registered_run_matches_one_rank(runs, world, opt):
    """The preset as registered (its generator draws the quorums on every
    rank): params within item 9's bounds of the one-rank run; with SGD
    every MDA selection the one-rank run's too. A rank that rejoined with a
    stale generator would draw other quorums. AdamW's run reaches
    gradients whose pairwise distances are float32 noise (~1e-12 by step
    10), where MDA's pick is a tie that the 'fsdp' ranks' summation order
    breaks otherwise than one rank does, so its selections are not held
    equal."""
    d, ref = runs
    ranks = _load(d, world, opt)
    params, sel = ref[f"one_{opt}"]
    picked = _sel(ranks[0][1])
    assert len(picked) == len(sel) == 24
    if opt == "sgd":
        for t, (a, b) in enumerate(zip(sel, picked)):
            np.testing.assert_array_equal(a > 0, b > 0, err_msg=f"step {t}")
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    l2, mx = _errors(ranks[0][1]["params"], params, _spans())
    print(f"W = {world}, {opt}: rel-L2 {l2:.2e}, rel-max {mx:.2e}")
    assert l2 < REL_L2 and mx < REL_MAX


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_results(runs, world):
    """Every rank returns rank 0's logs, final, buffers and provenance
    (but its wall), the same selections on every member at each step, the
    same whole
    stacks from ``whole_state`` (idle ranks included), and ends with the
    same step counter, AdamW count and generator state."""
    d, _ = runs
    for run in RUNS[world]:
        ranks = _load(d, world, run)
        rec0, arr0 = ranks[0]
        for r, (rec, arr) in enumerate(ranks):
            for k in ("logs", "final", "buffers", "provenance"):
                assert rec[k] == rec0[k], (run, r, k)
            assert rec["t"] == rec["whole_t"] == 24, (run, r)
            assert rec["gen"] == rec0["gen"], (run, r)
            assert rec["count"] == rec0["count"], (run, r)
            for k in arr0.files:
                if not k.startswith("sel"):
                    assert np.array_equal(arr[k], arr0[k]), (run, r, k)
            # a rank's selections by step: rank 0's at the same steps
            by_t = dict(zip((s["t"] for s in rec0["steps"]), _sel(arr0)))
            for s, a in zip(rec["steps"], _sel(arr)):
                assert np.array_equal(a, by_t[s["t"]]), (run, r, s["t"])


@pytest.mark.parametrize("world", WORLDS)
def test_reform_is_reform_params_of_the_whole_stacks(runs, world):
    """At each boundary, on every rank, the re-formed whole stacks (params;
    AdamW's m and v on W = 8) are bit-equal to ``reform_params`` of the
    incoming whole stacks; a rank keeps its block of the new mesh."""
    d, _ = runs
    for run in ("replay", "sgd", "adamw") if world == 8 else ("replay",
                                                              "sgd"):
        for r, (rec, _) in enumerate(_load(d, world, run)):
            bs = rec["boundaries"]
            assert [(b["G"], b["G_new"]) for b in bs] == [(5, 4), (4, 5)]
            for b in bs:
                want = ["params"] + (["m", "v"] if run == "adamw" else [])
                assert sorted(b["equal"]) == sorted(want)
                assert all(b["equal"].values()), (run, r, b)
                new = tuple(b["new"].values())
                rows, cols = b["block"]
                if r < int(np.prod(new)):
                    assert rows == b["G_new"] // new[0] and cols > 0
                else:
                    assert (rows, cols) == (b["G_new"], 0)


@pytest.mark.parametrize("world", WORLDS)
def test_step_bytes_match_the_volume_model(runs, world):
    """On every member and every segment, each scatter step's ``pull`` +
    ``aggregate`` bytes equal ``collective_volume_bytes`` for the
    segment's config and mesh, on the rank's columns."""
    d, _ = runs
    for run in ("replay", "sgd"):
        for r, (rec, _) in enumerate(_load(d, world, run)):
            used = [int(np.prod(s)) for s in MESHES[world]]
            starts = (0, 8, 16, 24)
            want_steps = sum(b - a for a, b, u in zip(starts, starts[1:],
                                                      used) if r < u)
            assert len(rec["steps"]) == want_steps, (run, r)
            for s in rec["steps"]:
                assert s["got"] == s["want"] > 0, (run, r, s)


@pytest.mark.parametrize("world", WORLDS)
def test_reform_bytes_match_the_formula(runs, world):
    """Every rank's ``reform`` bytes at each boundary equal
    ``reform_volume_bytes`` (the old mesh's gathers, and rank 0's stacks
    and run state to the joining ranks), with one stack (SGD) and three
    (AdamW); a rank idle in the old mesh sends 0."""
    d, _ = runs
    for run in ("sgd", "adamw") if world == 8 else ("sgd",):
        for r, (rec, _) in enumerate(_load(d, world, run)):
            for b in rec["boundaries"]:
                assert b["sent"] == b["want"], (run, r, b)
                if r >= int(np.prod(list(b["old"].values()))):
                    assert b["sent"] == 0


def test_reform_volume_bytes_by_hand():
    """The formula on the W = 8 boundaries at P = 1765, f32: (5,1,1) ->
    (4,2,1): a member sends its row to 4 others, rank 0 also the stack and
    the run state to ranks 5-7; (4,2,1) -> (5,1,1): 3 rows of its columns
    over 'rep', then 4 padded rows over 'fsdp'."""
    P = 1765
    a = tmem.reform_volume_bytes((5, 1, 1), (4, 2, 1), 5, P, 4, rank=1)
    assert a == 4 * P * 4
    a0 = tmem.reform_volume_bytes((5, 1, 1), (4, 2, 1), 5, P, 4, rank=0,
                                  run_state_bytes=100)
    assert a0 == 4 * P * 4 + 3 * (5 * P * 4 + 100)
    assert tmem.reform_volume_bytes((5, 1, 1), (4, 2, 1), 5, P, 4,
                                    rank=6) == 0
    for r, cols in ((2, 882), (3, 883)):
        b = tmem.reform_volume_bytes((4, 2, 1), (5, 1, 1), 4, P, 4, rank=r,
                                     stacks=3)
        assert b == 3 * 4 * (3 * cols + 4 * 883)
    with pytest.raises(ValueError, match="'model'"):
        tmem.reform_volume_bytes((2, 1, 2), (2, 1, 2), 4, P, 4, rank=0)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_checkpointed_run_is_the_uninterrupted_one(runs, opt):
    """On W = 8, ``ckpt_every=4`` changes nothing: params (and AdamW's
    moments), final and logs bit-identical to the run without
    checkpoints."""
    d, _ = runs
    whole, ckpt = _load(d, 8, opt), _load(d, 8, f"{opt}_ckpt")
    for (a, x), (b, y) in zip(whole, ckpt):
        assert a["final"] == b["final"] and a["logs"] == b["logs"]
        for k in ("params", "m", "v") if opt == "adamw" else ("params",):
            assert np.array_equal(x[k], y[k])


@pytest.mark.parametrize("world,opt", [(8, "sgd"), (8, "adamw"),
                                       (5, "sgd")])
def test_killed_and_resumed_is_bit_identical(runs, world, opt):
    """Killed after step 12 (the saves past it deleted) and resumed: the
    checkpoint at 12 names the G' = 4 fleet, the run resumes there
    (on W = 5 rank 4 sits that segment out and takes its counters from
    the files), and params, final and logs are bit-identical to the
    uninterrupted run."""
    d, _ = runs
    with open(d / f"w{world}_{opt}_meta12.json") as fh:
        meta = json.load(fh)
    assert meta["active"] == [0, 1, 2, 3] and meta["elastic"]
    whole, resumed = _load(d, world, opt), _load(d, world, f"{opt}_resumed")
    for (a, x), (b, y) in zip(whole, resumed):
        assert b["provenance"]["membership"]["resumed_at"] == 12
        assert a["final"] == b["final"]
        by_step = {m["step"]: m for m in a["logs"]}
        assert b["logs"] and all(m == by_step[m["step"]] for m in b["logs"])
        for k in ("params", "m", "v") if opt == "adamw" else ("params",):
            assert np.array_equal(x[k], y[k])
        assert a["gen"] == b["gen"] and b["t"] == 24


def test_one_rank_run_is_unchanged(runs):
    """The one-rank run on the segment meshes of a world of one: the
    (1, 1, 1) mesh, its stack whole, as ``runner="protocol"``."""
    _, ref = runs
    res = ref["one_sgd_res"]
    assert res.provenance["mesh"] == {"rep": 1, "fsdp": 1, "model": 1}
    assert tuple(res.state.params.shape) == (5, 1765)
    assert tproto.whole_state(res.state) is res.state


def test_protocol_runner_and_idle_collectives_refuse(runs):
    """On W = 5: ``runner="protocol"`` at G = 4 is refused on every rank
    (its mesh leaves a rank idle); the G' = 4 segment mesh leaves rank 4
    out, and a collective there raises."""
    d, _ = runs
    for r in range(5):
        with open(d / f"w5_refusals_{r}.json") as fh:
            rec = json.load(fh)
        assert rec["protocol"] and "launch 4" in rec["protocol"]
        assert rec["member"] == (r < 4)
        if r == 4:
            assert rec["collective"] and "sits the mesh out" in \
                rec["collective"]
        else:
            assert rec["collective"] is None

"""The 'model' axis (tensor parallelism) over ``torch.distributed`` ranks:
gloo ranks on the CPU, spawned once by ``tests/_torch_tp_runner.py``
(which imports no JAX), held against JAX's single-device protocol on the
same numpy params, batches and replayed quorum tables (the counterpart of
``tests/_protocol_runner.py`` at (rep 4, fsdp 1, model 2)), against the
port's single-card engine and against the byte models; quorum serving on a
(4, 2) serve mesh (``tests/_serve_runner.py`` part 2); ``launch.serve
--mesh 1x4`` against one rank; ``launch.train --mesh 4x2``, ``launch.serve
--mesh 2x2`` and the MoE's ``launch.train --mesh 2x2`` under ``torchrun``.
The MoE, hybrid, RWKV6 and audio families over ranks are
``tests/test_torch_tp_zoo.py``."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import attacks as jattacks
from repro.core import protocol as jproto
from repro.core.quorum import TraceDelivery as JTraceDelivery
from repro.models.registry import get_bundle as jax_bundle
from repro.optim import schedules as jsched
from repro_torch.core import protocol as tproto
from repro_torch.models.convert import protocol_state_from_jax
from repro_torch.models.registry import get_bundle

ROOT = Path(__file__).resolve().parents[1]
G, T, STEPS = 4, 3, 4                 # one DMC gather and a tail
ENGINES = ["sharded", "naive"]


def _jax_cfg():
    return jproto.ProtocolConfig.derive(G, T=T, byz=jattacks.ByzantineSpec(
        worker_attack="alie", n_byz_workers=1))


def _tables(rng, jp):
    """Numpy quorum tables (``tests/test_torch_dist.py``'s law)."""
    def pick(q, self_first=False):
        out = np.empty((G, q), np.int32)
        for r in range(G):
            if self_first:
                others = rng.permutation([s for s in range(G) if s != r])
                out[r] = np.concatenate([[r], others[:q - 1]])
            else:
                out[r] = rng.permutation(G)[:q]
        return out

    return (np.stack([pick(jp.q_servers) for _ in range(STEPS)]),
            np.stack([pick(jp.q_workers) for _ in range(STEPS)]),
            np.stack([pick(jp.q_servers, True) for _ in range(STEPS // T)]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's protocol run and the runner's results on the same inputs."""
    d = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(3)
    jp = _jax_cfg()
    tables = _tables(rng, jp)
    jb = jax_bundle("phi4-mini-3.8b", reduced=True, act_dtype="float32")
    toks = rng.integers(0, jb.cfg.vocab, (STEPS, G, 2, 17)).astype(np.int32)
    jeng = jproto.ProtocolEngine(jb, jp, jsched.inverse_linear(0.05, 0.05),
                                 delivery=JTraceDelivery(*tables, T=T),
                                 with_attack=True)
    j0 = jeng.init_state(jax.random.PRNGKey(0))
    flat0 = protocol_state_from_jax(jax.tree.map(np.asarray, j0), "cpu")
    np.savez(d / "inputs.npz", pull=tables[0], push=tables[1],
             gather=tables[2], tokens=toks, T=T,
             params=flat0.params.numpy())
    jend, _ = jeng.run(j0, {"tokens": jnp.asarray(toks[..., :-1]),
                            "labels": jnp.asarray(toks[..., 1:])},
                       epoch_steps=STEPS)
    want = protocol_state_from_jax(jax.tree.map(np.asarray, jend), "cpu")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, str(ROOT / "tests" /
                                              "_torch_tp_runner.py"),
                          str(d)], env=env, capture_output=True, text=True,
                         timeout=600)
    print(res.stdout)
    assert res.returncode == 0 and "TORCH_TP_RUNNER_DONE" in res.stdout, \
        res.stdout[-3000:] + res.stderr[-6000:]
    return d, want


def _leaf_errors(got, want, tree):
    """Worst per-leaf relative L2 and relative max over the stack."""
    l2 = mx = 0.0
    for off, size in tree.spans():
        a, b = got[:, off:off + size], want[:, off:off + size]
        diff = a - b
        l2 = max(l2, np.linalg.norm(diff) / (np.linalg.norm(b) + 1e-6))
        mx = max(mx, np.abs(diff).max() / (np.abs(b).max() + 1e-6))
    return l2, mx


@pytest.mark.parametrize("engine", ENGINES)
def test_model2_protocol_matches_jax(runs, engine):
    """8 ranks at (rep 4, fsdp 1, model 2), f32: per-leaf rel-L2 < 1e-5
    and rel-max < 1e-4 against JAX's one-device protocol (float32
    summation order: the row-parallel products sum two partials, the
    vocab-parallel loss its statistics over two blocks), every MDA
    selection equal to JAX's."""
    d, want = runs
    got = np.load(d / f"tp_{engine}.npz")
    l2, mx = _leaf_errors(got["params"], want.params.numpy(), want.tree)
    print(f"{engine}: rel-L2 {l2:.2e}, rel-max {mx:.2e}")
    assert l2 < 1e-5 and mx < 1e-4
    np.testing.assert_allclose(got["params"], want.params.numpy(),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("engine", ENGINES)
def test_model2_selections_equal_single_card(runs, engine):
    """Every step's MDA weights on the 8 ranks equal the port's single-card
    engine's (the same selection, weights to float32 rounding), and the
    params agree to float32 rounding."""
    d, _ = runs
    got, single = (np.load(d / f"tp_{engine}.npz"),
                   np.load(d / f"single_{engine}.npz"))
    assert got["sel"].shape[0] == STEPS
    for a, b in zip(got["sel"], single["sel"]):
        np.testing.assert_array_equal(a > 0, b > 0)
        np.testing.assert_allclose(a, b, rtol=1e-6)
    np.testing.assert_allclose(got["params"], single["params"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("engine", ENGINES)
def test_model2_bytes_match_the_formulas(runs, engine):
    """Each rank's bytes on a step: ``pull`` + ``aggregate`` within 10 %
    of ``collective_volume_bytes(model=2)`` and equal to it on the rank's
    blocks (``n_params=P_m``); ``model``, ``model_leaves`` and
    ``model_loss`` equal to ``model_volume_bytes`` for one group of 2 x
    16 tokens."""
    d, want = runs
    P = want.tree.size
    pcfg = tproto.ProtocolConfig.derive(G, T=T)
    cfg = get_bundle("phi4-mini-3.8b", reduced=True,
                     act_dtype="float32").cfg
    tp = tproto.model_volume_bytes(cfg, 2, 2 * 16)
    assert set(tp) == {"model", "model_leaves", "model_loss"}
    model = tproto.collective_volume_bytes(pcfg, P, model=2)
    for rank in range(8):
        rec = json.load(open(d / f"tp_{engine}_sent_{rank}.json"))
        assert rec["mesh"] == {"rep": 4, "fsdp": 1, "model": 2}
        exact = tproto.collective_volume_bytes(pcfg, rec["P_m"])
        for i, sent in enumerate(rec["sent"]):
            got = sent["pull"] + sent["aggregate"]
            assert abs(got - model) <= 0.1 * model, (rank, i, got, model)
            assert got == exact
            for tag, n in tp.items():
                assert sent[tag] == n, (rank, i, tag, sent[tag], n)


def test_model2_checkpoint_round_trip(runs):
    """A save of the (rep 4, model 2) state gathers it whole; a restore
    into the mesh gives every rank its blocks back, bit-equal."""
    d, _ = runs
    for rank in range(8):
        rec = json.load(open(d / f"ckpt_{rank}.json"))
        assert rec["equal"] and rec["step"] == STEPS


def test_quorum_serving_on_a_4x2_serve_mesh(runs):
    """``QuorumService`` under ``serve_rules`` of the (4, 2) serve mesh,
    reduced phi4-mini: 4 replicas with replica 3 reversed give the tokens
    of the honest replica on the same mesh, on every rank; replica 3 is
    ejected; each rank holds half of ``w_gate``'s columns."""
    d, _ = runs
    recs = [json.load(open(d / f"serve_{r}.json")) for r in range(8)]
    for rec in recs:
        assert rec["mesh"] == {"data": 4, "model": 2}
        assert rec["quorum"] == rec["honest"] == recs[0]["honest"]
        assert [i for _, i in rec["ejections"]] == [3]
        assert rec["w_gate"][-1] == 256 // 2


def test_launch_serve_zero_over_data(runs):
    """``launch.serve --mesh 4x2`` with the ZeRO threshold at 0 bytes
    (every leaf's 'model' block split over 'data' as well, each layer's
    leaves gathered at use; the 4 rows one a 'data' rank): every rank
    returns the single rank's greedy tokens."""
    d, _ = runs
    want = json.load(open(d / "serve_b4.json"))
    for r in range(8):
        assert json.load(open(d / f"serve_{r}.json"))["zero_ids"] == want


def _ids(run):
    assert run["rc"] == 0, run["stderr"]
    line = [l for l in run["stdout"].splitlines() if "sample" in l][-1]
    return json.loads(line.split("ids:")[1])


def test_launch_serve_mesh_1x4_matches_one_rank(runs):
    """``launch.serve --mesh 1x4`` (reduced phi4-mini: 4 heads split, 2 kv
    heads computed whole on every rank): the greedy tokens of the
    single-rank run, bf16, token for token."""
    d, _ = runs
    rec = json.load(open(d / "launch.json"))
    assert _ids(rec["serve_1x4"]) == _ids(rec["serve_1x1"])
    assert "'model': 4" in rec["serve_1x4"]["stdout"]


def test_launchers_under_torchrun(runs):
    """``launch.train --mesh 4x2`` (8 ranks): 2 steps, finite losses, the
    (rep 4, fsdp 1, model 2) mesh; ``launch.serve --mesh 2x2`` the
    single-rank tokens; ``--arch qwen3-moe-235b-a22b --reduced --mesh
    2x2`` (4 ranks, G = 2: the MoE family at rep 2 x model 2): 2 steps,
    finite losses. Every run exits 0: each launcher leaves the process
    group it joined."""
    d, _ = runs
    rec = json.load(open(d / "launch.json"))
    run = rec["train_4x2"]
    assert run["rc"] == 0, run["stderr"]
    losses = [float(l.split("loss")[1].split()[0])
              for l in run["stdout"].splitlines() if "[train] step" in l]
    assert len(losses) == 2 and np.all(np.isfinite(losses)), run["stdout"]
    assert "'rep': 4, 'fsdp': 1, 'model': 2" in run["stdout"]
    assert _ids(rec["serve_2x2"]) == _ids(rec["serve_1x1"])
    moe = rec["moe_2x2"]
    assert moe["rc"] == 0, moe["stderr"]
    losses = [float(l.split("loss")[1].split()[0])
              for l in moe["stdout"].splitlines() if "[train] step" in l]
    assert len(losses) == 2 and np.all(np.isfinite(losses)), moe["stdout"]
    assert "qwen3-moe-235b-a22b" in moe["stdout"]
    assert "'rep': 2, 'fsdp': 1, 'model': 2" in moe["stdout"]

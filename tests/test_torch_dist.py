"""The port's protocol over ``torch.distributed`` ranks: gloo ranks on the
CPU, spawned once by ``tests/_torch_dist_runner.py`` (which imports no
JAX), held against JAX's single-device protocol on the same numpy params,
batches and replayed quorum tables (the harness of
``tests/test_torch_protocol.py``), against the port's single-card engine,
and against ``collective_volume_bytes``; ``serve/ckpt_smoke`` at rep 5
restored into a pool; ``launch.train --mesh 4x1`` under ``torchrun``."""
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

ROOT = Path(__file__).resolve().parents[1]
G, T, STEPS = 4, 2, 5                 # two DMC gathers and a tail


def _tables(rng):
    """Numpy quorum tables (``tests/test_torch_protocol.py``'s law)."""
    def pick(q, self_first=False):
        out = np.empty((G, q), np.int32)
        for r in range(G):
            if self_first:
                others = rng.permutation([s for s in range(G) if s != r])
                out[r] = np.concatenate([[r], others[:q - 1]])
            else:
                out[r] = rng.permutation(G)[:q]
        return out

    jp = _jax_cfg()
    return (np.stack([pick(jp.q_servers) for _ in range(STEPS)]),
            np.stack([pick(jp.q_workers) for _ in range(STEPS)]),
            np.stack([pick(jp.q_servers, True) for _ in range(STEPS // T)]))


def _jax_cfg():
    return jproto.ProtocolConfig.derive(G, T=T, byz=jattacks.ByzantineSpec(
        worker_attack="alie", n_byz_workers=1))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's protocol run and the runner's results on the same inputs."""
    d = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(1)
    tables = _tables(rng)
    jb = jax_bundle("phi4-mini-3.8b", reduced=True, act_dtype="float32")
    toks = rng.integers(0, jb.cfg.vocab, (STEPS, G, 2, 17)).astype(np.int32)
    jeng = jproto.ProtocolEngine(jb, _jax_cfg(),
                                 jsched.inverse_linear(0.05, 0.05),
                                 delivery=JTraceDelivery(*tables, T=T),
                                 with_attack=True)
    j0 = jeng.init_state(jax.random.PRNGKey(0))
    flat0 = protocol_state_from_jax(jax.tree.map(np.asarray, j0), "cpu")
    toks3 = rng.integers(0, jb.cfg.vocab, (STEPS, G, 3, 17)).astype(np.int32)
    np.savez(d / "inputs.npz", pull=tables[0], push=tables[1],
             gather=tables[2], tokens=toks, tokens3=toks3, T=T,
             params=flat0.params.numpy())
    jend, _ = jeng.run(j0, {"tokens": jnp.asarray(toks[..., :-1]),
                            "labels": jnp.asarray(toks[..., 1:])},
                       epoch_steps=STEPS)
    want = protocol_state_from_jax(jax.tree.map(np.asarray, jend), "cpu")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, str(ROOT / "tests" /
                                              "_torch_dist_runner.py"),
                          str(d)], env=env, capture_output=True, text=True,
                         timeout=420)
    print(res.stdout)
    assert res.returncode == 0 and "TORCH_DIST_RUNNER_DONE" in res.stdout, \
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


@pytest.mark.parametrize("engine", ["sharded", "naive"])
def test_rep4_fsdp2_matches_jax(runs, engine):
    """8 ranks at (rep 4, fsdp 2): per-leaf rel-L2 < 2e-2 and rel-max <
    1e-1 against JAX's one-device protocol (the reference's 2D oracle
    bounds, ``tests/_exp_2d_runner.py``), and every MDA selection equal to
    the port's single-card run."""
    d, want = runs
    got = np.load(d / f"w8_{engine}.npz")
    single = np.load(d / "single.npz")
    l2, mx = _leaf_errors(got["params"], want.params.numpy(), want.tree)
    same = int(sum(np.array_equal(a > 0, b > 0)
                   for a, b in zip(got["sel"], single["sel"])))
    print(f"{engine}: rel-L2 {l2:.2e}, rel-max {mx:.2e}; {same} of "
          f"{STEPS} MDA selections equal to the single card's")
    assert l2 < 2e-2 and mx < 1e-1
    assert same == STEPS
    np.testing.assert_allclose(got["params"], want.params.numpy(),
                               rtol=2e-4, atol=2e-5)


def test_rep4_matches_single_card(runs):
    """4 ranks at (rep 4, fsdp 1) with the ALIE worker against the port's
    single-card engine. The pulls, gradients, ALIE payloads and quorum
    tables are the same computations; the Gram adds its partials in
    another order and the aggregation's sum over senders is a float32 add
    in sender order where the single card's is one BLAS product (whose
    order and fused multiply-adds the library picks), so the test holds
    params to float32 rounding; on the CPU they came out bit-equal, which
    it prints. Every MDA selection is equal."""
    d, _ = runs
    got, single = np.load(d / "w4_sharded.npz"), np.load(d / "single.npz")
    print("bit-equal to the single card:",
          np.array_equal(got["params"], single["params"]))
    for a, b in zip(got["sel"], single["sel"]):
        np.testing.assert_array_equal(a > 0, b > 0)
        np.testing.assert_allclose(a, b, rtol=1e-6)
    np.testing.assert_allclose(got["params"], single["params"], rtol=1e-5,
                               atol=1e-6)


def test_uneven_fsdp_parts_match_single_card(runs):
    """3 batch rows a group on (rep 4, fsdp 2): one 'fsdp' rank
    differentiates 1 row, the other 2, each weighted by its share of the
    rows; against the single card on the same batches every MDA selection
    is equal and the params agree to float32 rounding."""
    d, _ = runs
    got, single = np.load(d / "w8_uneven.npz"), np.load(d / "single3.npz")
    for a, b in zip(got["sel"], single["sel"]):
        np.testing.assert_array_equal(a > 0, b > 0)
    np.testing.assert_allclose(got["params"], single["params"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("engine", ["sharded", "naive"])
def test_bytes_sent_match_the_volume_model(runs, engine):
    """Each rank's bytes under ``pull`` and ``aggregate`` on a scatter step
    within 10 % of ``collective_volume_bytes(fsdp=2)`` (the tolerance of
    the reference's HLO audit); the terms outside the model at the sizes
    its docstring states."""
    d, want = runs
    P = want.tree.size
    pcfg = tproto.ProtocolConfig.derive(G, T=T)
    model = tproto.collective_volume_bytes(pcfg, P, fsdp=2)
    for rank in range(8):
        rec = json.load(open(d / f"w8_{engine}_sent_{rank}.json"))
        assert rec["mesh"] == {"rep": 4, "fsdp": 2, "model": 1}
        k0, k1 = rec["layout"]["cols"]
        pk = k1 - k0
        for i, sent in enumerate(rec["sent"]):
            got = sent["pull"] + sent["aggregate"]
            assert abs(got - model) <= 0.1 * model, (rank, i, got, model)
            # gram: (rep-1)/rep of the padded [4, ceil(pk/4)] chunk, plus
            # the [G, G] partials over fsdp (1 x) and rep (3 x 2 blocks)
            gram = 3 * -(-pk // 4) * 4 + (1 + 3 * 2) * G * G * 4
            assert sent["gram"] == gram, (rank, i, sent["gram"], gram)
            # fsdp: the pulled row gathered (1 x ceil(P/2) f32) and the
            # gradient parts summed (1/2 of [1, 2 ceil(P/2)] f32)
            assert sent["fsdp"] == 2 * -(-P // 2) * 4
            if (i + 1) % T == 0:
                assert sent["gather"] == 3 * pk * 4
            else:
                assert "gather" not in sent or sent["gather"] == 0


def test_ckpt_smoke_at_rep5_restores_into_a_pool(runs):
    """``serve/ckpt_smoke`` on 5 ranks (rep 5): the latest checkpoint
    restores into a 5-replica pool equal to the whole final state."""
    d, _ = runs
    rec = json.load(open(d / "ckpt.json"))
    assert rec["mesh"] == {"rep": 5, "fsdp": 1, "model": 1}
    assert rec["latest"] == rec["steps"] and rec["n_replicas"] == 5
    assert rec["equal"] and np.isfinite(rec["acc"])


def test_launch_train_under_torchrun(runs):
    """``torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.
    train --mesh 4x1``: 2 steps, finite losses printed by rank 0 alone;
    ``--arch qwen3-moe-235b-a22b --mesh 4x2`` on one process is refused
    up front: the MoE family takes the 'model' axis, and the mesh needs 8
    ranks."""
    d, _ = runs
    rec = json.load(open(d / "launch.json"))
    assert rec["rc"] == 0, rec["stderr"]
    losses = [float(l.split("loss")[1].split()[0])
              for l in rec["stdout"].splitlines() if "[train] step" in l]
    assert len(losses) == 2 and np.all(np.isfinite(losses)), rec["stdout"]
    assert "'rep': 4" in rec["stdout"]
    assert rec["refused_rc"] != 0
    assert "needs 8 ranks" in rec["refused_stderr"]
    assert "item 1" not in rec["refused_stderr"]

"""The 'model' axis (tensor parallelism) for the MoE, hybrid, RWKV6 and
audio families over ``torch.distributed`` ranks: 4 gloo ranks on the CPU
at (rep 2, fsdp 1, model 2), spawned once by
``tests/_torch_tp_zoo_runner.py`` (which imports no JAX), held against
JAX's single-device protocol on the same numpy params, batches (whisper's
encoder frames too) and replayed quorum tables, and against the byte
model; a checkpoint round trip at model 2; split decoding on a (2, 2)
serve mesh against one rank for every family, and quorum serving on it
for the token-in families.
The dense and vlm families are ``tests/test_torch_tp.py``."""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import jax_tree, numpy_params
from _torch_tp_zoo_runner import OVERRIDES, bundle_of
from repro.core import attacks as jattacks
from repro.core import protocol as jproto
from repro.core.quorum import TraceDelivery as JTraceDelivery
from repro.models.registry import get_bundle as jax_bundle
from repro.optim import schedules as jsched
from repro_torch.core import protocol as tproto
from repro_torch.models.convert import protocol_state_from_jax

ROOT = Path(__file__).resolve().parents[1]

G, T, STEPS = 4, 2, 3                 # one DMC gather and a tail
B, S = 2, 8                           # rows and tokens a group a step
ARCHS = list(OVERRIDES)
SERVED = [a for a in ARCHS if a != "whisper-small"]


def _tables(rng, jp):
    """Numpy quorum tables (``tests/test_torch_tp.py``'s law)."""
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


def _inputs(arch, d: Path, rng):
    """Numpy params (one draw a replica), batches and quorum tables of
    ``arch``, saved for the runner (the params in JAX's leaf order).
    Returns (the reduced config, tables, params, batch)."""
    jb = jax_bundle(arch, reduced=True, act_dtype="float32",
                    param_dtype="float32", **OVERRIDES[arch])
    jp = _pcfg()
    tables = _tables(rng, jp)
    reps = [numpy_params(jb.cfg, seed=g) for g in range(G)]
    stacked = jax.tree.map(lambda *x: np.stack(x), *reps)
    toks = rng.integers(0, jb.cfg.vocab, (STEPS, G, B, S + 1)).astype(
        np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if jb.cfg.family == "audio":
        batch["enc_frames"] = (0.5 * rng.standard_normal(
            (STEPS, G, B, 2 * S, jb.cfg.d_model))).astype(np.float32)
    flat0 = protocol_state_from_jax(types.SimpleNamespace(
        params=stacked, t=0, opt=()), "cpu")
    np.savez(d / f"{arch}.npz", pull=tables[0], push=tables[1],
             gather=tables[2], T=T, params=flat0.params.numpy(),
             **{f"b_{k}": v for k, v in batch.items()})
    return jb, tables, stacked, batch


def _pcfg():
    return jproto.ProtocolConfig.derive(G, T=T, byz=jattacks.ByzantineSpec(
        worker_attack="alie", n_byz_workers=1))


def _jax_run(jb, tables, stacked, batch):
    """JAX's protocol on the inputs, every MDA selection recorded.
    Returns (the final state in the port's layout, the selections)."""
    jeng = jproto.ProtocolEngine(jb, _pcfg(),
                                 jsched.inverse_linear(0.05, 0.05),
                                 delivery=JTraceDelivery(*tables, T=T),
                                 with_attack=True)
    j0 = jproto.ByzState(params=jax_tree(stacked), t=jnp.zeros((), jnp.int32),
                         key=jax.random.PRNGKey(0), opt=())
    sel = []
    jq = jproto.quorum_weights

    def rec(d2, idx, f, cfg):
        w = jq(d2, idx, f, cfg)
        jax.debug.callback(lambda x: sel.append(np.asarray(x)), w,
                           ordered=True)
        return w

    jproto.quorum_weights = rec
    try:
        jend, _ = jeng.run(j0, {k: jnp.asarray(v) for k, v in batch.items()},
                           epoch_steps=STEPS)
        jax.effects_barrier()
    finally:
        jproto.quorum_weights = jq
    want = protocol_state_from_jax(jax.tree.map(np.asarray, jend), "cpu")
    return want, np.stack(sel)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The runner on the saved inputs, while JAX runs the same."""
    d = tmp_path_factory.mktemp("tp_zoo")
    rng = np.random.default_rng(5)
    inputs = {arch: _inputs(arch, d, rng) for arch in ARCHS}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" /
                                                 "_torch_tp_zoo_runner.py"),
                             str(d)] + ARCHS, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        want = {arch: _jax_run(*inputs[arch]) for arch in ARCHS}
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    print(out)
    assert proc.returncode == 0 and "TORCH_TP_ZOO_RUNNER_DONE" in out, \
        out[-3000:] + err[-6000:]
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


@pytest.mark.parametrize("arch", ARCHS)
def test_model2_protocol_matches_jax(runs, arch):
    """4 ranks at (rep 2, fsdp 1, model 2), f32, an ALIE worker, T + 1
    steps with one DMC gather: per-leaf rel-L2 < 1e-5 and rel-max < 1e-4
    against JAX's one-device protocol (float32 summation order: the
    row-parallel products sum two partials, the MoE its combined partials,
    the vocab-parallel loss its statistics over two blocks), every MDA
    selection equal to JAX's."""
    d, (want, jsel) = runs[0], runs[1][arch]
    got = np.load(d / f"{arch}_tp.npz")
    l2, mx = _leaf_errors(got["params"], want.params.numpy(), want.tree)
    print(f"{arch}: rel-L2 {l2:.2e}, rel-max {mx:.2e}")
    assert l2 < 1e-5 and mx < 1e-4
    assert got["sel"].shape[0] == jsel.shape[0] == STEPS
    for a, b in zip(got["sel"], jsel):
        np.testing.assert_array_equal(a > 0, b > 0)
        np.testing.assert_allclose(a, b, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_model2_bytes_match_the_formulas(runs, arch):
    """Each rank's bytes on every step under ``model``, ``model_leaves``
    and ``model_loss`` equal ``model_volume_bytes`` for its two groups of
    B x S tokens (whisper: 2S encoder frames a row, S decoder positions);
    ``pull`` + ``aggregate`` equal ``collective_volume_bytes`` on the
    rank's blocks."""
    d = runs[0]
    cfg = bundle_of(arch).cfg
    kw = dict(seq=S, frames=B * 2 * S) if cfg.family == "audio" else {}
    tp = tproto.model_volume_bytes(cfg, 2, B * S, n_groups=G // 2, **kw)
    assert set(tp) == {"model", "model_leaves", "model_loss"}
    pcfg = tproto.ProtocolConfig.derive(G, T=T)
    for rank in range(4):
        rec = json.load(open(d / f"{arch}_sent_{rank}.json"))
        assert rec["mesh"] == {"rep": 2, "fsdp": 1, "model": 2}
        exact = tproto.collective_volume_bytes(pcfg, rec["P_m"], rep=2)
        assert len(rec["sent"]) == STEPS
        for i, sent in enumerate(rec["sent"]):
            assert sent["pull"] + sent["aggregate"] == exact
            for tag, n in tp.items():
                assert sent[tag] == n, (rank, i, tag, sent[tag], n)


@pytest.mark.parametrize("arch", SERVED)
def test_quorum_serving_on_a_2x2_serve_mesh(runs, arch):
    """``QuorumService`` under ``serve_rules`` of the (2, 2) serve mesh,
    bf16: 4 replicas with replica 3 reversed give the honest replica's
    tokens on every rank, and replica 3 is ejected."""
    d = runs[0]
    recs = [json.load(open(d / f"serve_{r}.json")) for r in range(4)]
    for rec in recs:
        assert rec["mesh"] == {"data": 2, "model": 2}
        got = rec[arch]
        assert got["quorum"] == got["honest"] == recs[0][arch]["honest"]
        assert [i for _, i in got["ejections"]] == [3]


@pytest.mark.parametrize("arch", SERVED)
def test_quorum_serving_at_model_2_matches_one_rank(runs, arch):
    """The honest replica's ``QuorumService`` in f32 under the (2, 2) serve
    mesh's rules gives, on every rank, the tokens of the same service whole
    on one rank with no rules (slots decoding alone at B = 1 on the
    chunk-split caches and the whole recurrent state)."""
    d = runs[0]
    for r in range(4):
        got = json.load(open(d / f"serve_{r}.json"))[arch]
        assert got["f32_mesh"] == got["f32_single"], (r, got)


@pytest.mark.parametrize("arch", ARCHS)
def test_model2_split_decode_matches_one_rank(runs, arch):
    """Each reduced family (whisper's split decode too) in f32 weights,
    activations and caches, prefilled on 2 x 8 and decoded 3 steps
    greedily, split over 'model' on the (2, 2) serve mesh: every step's
    logits within rel-L2 1e-5 of the same rows run whole on the rank
    (float32 summation order), the tokens equal, on every rank."""
    d = runs[0]
    for r in range(4):
        got = json.load(open(d / f"serve_{r}.json"))[arch]["decode"]
        print(f"{arch} rank {r}: rel-L2 by step {got['rel_l2']}")
        assert got["rows"] == 1 and got["tokens_equal"], (r, got)
        assert len(got["rel_l2"]) == 4 and max(got["rel_l2"]) < 1e-5, \
            (r, got)


@pytest.mark.parametrize("arch", ARCHS)
def test_model2_checkpoint_round_trip(runs, arch):
    """A save of the (rep 2, model 2) state gathers it whole; a restore
    into the mesh gives every rank its blocks back, bit-equal."""
    d = runs[0]
    for rank in range(4):
        rec = json.load(open(d / f"{arch}_sent_{rank}.json"))["ckpt"]
        assert rec["equal"] and rec["step"] == STEPS


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_view_counts_the_gloo_ranks_bytes(runs, arch):
    """The dry run of the same scatter step on a rank view of the (rep 2,
    fsdp 1, model 2) mesh — meta tensors, no world — counts, for every
    rank, the bytes by tag that rank's ``Mesh.sent`` recorded in the gloo
    run's first step; pull + aggregate and the 'model' tags equal the
    formulas."""
    import torch

    from repro_torch.core.attacks import ByzantineSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AXES, RankView
    from repro_torch.optim import schedules as tsched
    d = runs[0]
    bundle = bundle_of(arch)
    cfg = bundle.cfg
    pcfg = tproto.ProtocolConfig.derive(G, T=T, byz=ByzantineSpec(
        worker_attack="alie", n_byz_workers=1))
    kw = dict(seq=S, frames=B * 2 * S) if cfg.family == "audio" else {}
    tp = tproto.model_volume_bytes(cfg, 2, B * S, n_groups=G // 2, **kw)
    batch = {k: torch.empty((G, B, S), dtype=torch.long, device="meta")
             for k in ("tokens", "labels")}
    if cfg.family == "audio":
        batch["enc_frames"] = torch.empty((G, B, 2 * S, cfg.d_model),
                                          device="meta")
    for rank in range(4):
        view = RankView(AXES, (2, 1, 2), rank=rank)
        state = tproto.make_init_fn(bundle, pcfg, "meta", view)(0)
        step = tproto.make_scatter_step(bundle, pcfg,
                                        tsched.inverse_linear(0.05, 0.05),
                                        with_attack=True, mesh=view)
        fig, _ = dryrun.measure(step, (state, batch), view)
        got = {k: int(v) for k, v in fig["collective_bytes_by_kind"].items()}
        rec = json.load(open(d / f"{arch}_sent_{rank}.json"))
        want = {k: v for k, v in rec["sent"][0].items() if v}
        assert got == want, (rank, got, want)
        exact = tproto.collective_volume_bytes(pcfg, rec["P_m"], rep=2)
        assert got["pull"] + got["aggregate"] == exact
        for tag, n in tp.items():
            assert got[tag] == n

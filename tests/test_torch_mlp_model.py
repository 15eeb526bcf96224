"""The 'model' axis (tensor parallelism) for the paper's MLPs: the
reference's per-leaf placement of every MLP of ``repro.exp.spec.MODELS``,
the split form of ``repro_torch.configs.paper_models`` against JAX's loss
and ``jax.grad``, and the protocol of an MLP ``ProblemBundle`` over gloo
ranks on the CPU at (rep 2, fsdp 1, model 2) and (rep 1, fsdp 2, model 2),
both engines, both pulls, with an ALIE worker on replayed quorum tables,
held to JAX's one-device protocol, to the port's one-rank run and to the
byte formulas. The ranks are spawned once by
``tests/_torch_mlp_model_runner.py``, which imports no JAX."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_models as jmodels
from repro.core import attacks as jattacks
from repro.core import protocol as jproto
from repro.core.quorum import TraceDelivery as JTraceDelivery
from repro.exp import spec as jspec
from repro.optim import schedules as jsched
from repro_torch.configs import paper_models as tmodels
from repro_torch.core import protocol as tproto
from repro_torch.core.simulator import FlatTree
from repro_torch.exp import spec as tspec
from repro_torch.launch import mesh as tmesh
from repro_torch.models.convert import protocol_state_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_mlp_model_runner import RUNS, run_name  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: mlp_h64 on mixture10: dim 32, hidden 64, 10 classes, depth 2
MLP = (32, 64, 10, 2)
G, T, STEPS, BATCH, LR = 4, 3, 4, 6, (0.2, 0.05)
#: the split form's cases (dim, hidden, classes, depth): mlp_h64's w0
#: column- and w1, w2 row-parallel; depth 3 (a row layer after a row
#: layer scatters its input); a first layer row-parallel on the data; a
#: whole hidden weight between a row layer and a column-parallel last
#: layer (its split logits gathered); a column layer whose input is split
CASES = [MLP, (32, 64, 10, 3), (64, 16, 10, 2), (6, 9, 4, 2), (4, 6, 8, 1)]
CASE_DIMS = [[None, None, None, 1, 0, 0],
             [None, None, None, None, 1, 0, 0, 0],
             [None, None, None, 0, 0, 0],
             [None, None, None, 0, None, 1],
             [None, None, 1, 1]]
CASE_ROWS = 7
# ranks against one device, float32 summation order (the row-parallel
# products sum two partials, the L2 term its blocks')
REL_L2, REL_MAX = 1e-5, 1e-4


def _tables(rng, jp):
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


def _jax_cfg(pull):
    return jproto.ProtocolConfig.derive(G, T=T, pull=pull,
                                        byz=jattacks.ByzantineSpec(
                                            worker_attack="alie",
                                            n_byz_workers=1))


def _case_inputs(rng, c, case):
    dim, hidden, classes, depth = case
    sizes = [dim] + [hidden] * depth + [classes]
    out = {f"case{c}_mlp": np.asarray(case)}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        out[f"case{c}_w{i}"] = (rng.standard_normal((a, b))
                                / np.sqrt(a)).astype(np.float32)
        out[f"case{c}_b{i}"] = (0.1 * rng.standard_normal(b)).astype(
            np.float32)
    y = rng.integers(0, classes, CASE_ROWS)
    out[f"case{c}_x"] = (rng.standard_normal((CASE_ROWS, dim))
                         + np.eye(classes, dim)[y]).astype(np.float32)
    out[f"case{c}_y"] = y.astype(np.int32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's one-device protocol run of each pull, and the runner's
    records."""
    d = tmp_path_factory.mktemp("mlp_model")
    rng = np.random.default_rng(11)
    jp = _jax_cfg("median")
    tables = _tables(rng, jp)
    mix = tspec.DATA["mixture10"]
    y = rng.integers(0, mix.n_classes, (STEPS, G, BATCH))
    centres = mix.sep * rng.standard_normal((mix.n_classes, mix.dim))
    x = (centres[y] + mix.noise * rng.standard_normal(y.shape + (mix.dim,))
         ).astype(np.float32)
    ey = rng.integers(0, mix.n_classes, 64)
    ex = (centres[ey] + mix.noise * rng.standard_normal((64, mix.dim))
          ).astype(np.float32)
    jinit, jloss, _ = jmodels.make_mlp_problem(*MLP)
    want = {}
    for pull in ("median", "roundrobin"):
        jeng = jproto.ProtocolEngine(
            jproto.ProblemBundle(jinit, jloss), _jax_cfg(pull),
            jsched.inverse_linear(*LR), delivery=JTraceDelivery(*tables, T=T),
            with_attack=True)
        j0 = jeng.init_state(jax.random.PRNGKey(0))
        # the engine donates its state: the initial stack is read first
        params0 = protocol_state_from_jax(jax.tree.map(np.asarray, j0),
                                          "cpu")
        jend, _ = jeng.run(j0, (jnp.asarray(x), jnp.asarray(y.astype(
            np.int32))), epoch_steps=STEPS)
        want[pull] = protocol_state_from_jax(
            jax.tree.map(np.asarray, jend), "cpu").params.numpy()
    cases = {}
    for c, case in enumerate(CASES):
        cases.update(_case_inputs(rng, c, case))
    np.savez(d / "inputs.npz", mlp=np.asarray(MLP), G=G, T=T,
             lr=np.asarray(LR), pull=tables[0], push=tables[1],
             gather=tables[2], x=x, y=y.astype(np.int64), ex=ex,
             ey=ey.astype(np.int64), params0=params0.params.numpy(),
             n_cases=len(CASES), **cases)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(ROOT / "tests" /
                                              "_torch_mlp_model_runner.py"),
                          str(d)], env=env, capture_output=True, text=True,
                         timeout=300)
    print(res.stdout)
    print(f"[mlp-model] the ranks' subprocess: "
          f"{time.perf_counter() - t0:.1f} s")
    assert res.returncode == 0 and "TORCH_MLP_MODEL_RUNNER_DONE" in \
        res.stdout, res.stdout[-3000:] + res.stderr[-6000:]
    return d, want, params0.tree


def _records(d, r) -> dict:
    with open(d / f"ranks_{r}.json") as fh:
        return json.load(fh)


def _rank(d, name, r):
    """Rank r's record of run ``name`` and its arrays."""
    return _records(d, r)[name], np.load(d / f"{name}_{r}.npz")


def _leaf_errors(got, want, tree):
    """Worst per-leaf relative L2 and relative max over the stack."""
    l2 = mx = 0.0
    for off, size in tree.spans():
        a, b = got[:, off:off + size], want[:, off:off + size]
        l2 = max(l2, np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))
        mx = max(mx, np.abs(a - b).max() / (np.abs(b).max() + 1e-12))
    return l2, mx


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", [m for m in tspec.MODELS
                                   if not tspec.is_arch_model(m)])
def test_model_dims_are_the_reference_placement(model):
    """For every mixture, at M 2 and 4 and K 1 and 2: ``model_dims`` of
    the MLP's tree (no overrides) is the 'model' dim of
    ``repro.core.protocol.leaf_spec`` for each leaf (whole below 3
    values, as ``state_shardings`` keeps them), and ``model_split`` takes
    it for a ``ProblemBundle``'s config."""
    m = tspec.MODELS[model]
    assert jspec.MODELS[model] == m
    for data, mix in tspec.DATA.items():
        if not hasattr(mix, "n_classes"):
            continue
        init, _, _ = tmodels.make_mlp_problem(mix.dim, m["hidden"],
                                              mix.n_classes, m["depth"])
        tree = FlatTree.from_params(tproto.ProblemBundle(
            init, None).meta_params())
        for M in (2, 4):
            for K in (1, 2):
                jmesh = SimpleNamespace(axis_names=("rep", "fsdp", "model"),
                                        devices=np.empty((1, K, M)))
                want = []
                for path, shape in zip(tree.paths, tree.shapes):
                    if np.prod(shape) <= 2:
                        want.append(None)
                        continue
                    spec = jproto.leaf_spec((1,) + shape, jmesh,
                                            name=path[-1],
                                            overrides=jproto.attn_overrides(
                                                None, jmesh))[1:]
                    want.append(spec.index("model") if "model" in spec
                                else None)
                got = tproto.model_dims(tree, M, None)
                assert got == want, (data, M, K, got, want)
                view = tmesh.Mesh(tmesh.AXES, (1, K, M), rank=M - 1)
                split = tproto.model_split(tproto._ProblemCfg(), tree, view)
                assert split.dims == got and split.m == M - 1


# ---------------------------------------------------------------------------
# the split form
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", range(len(CASES)))
def test_split_loss_and_grads_match_jax(runs, c):
    """On the 'model' line of ranks 0 and 1: the split form's loss equals
    JAX's ``mlp_loss`` (rtol 1e-5) on both ranks bit for bit, the rank's
    gradient blocks joined equal ``jax.grad`` (rtol 1e-4, atol 1e-6), the
    placement is the case's, and the bytes each rank sends by tag equal
    ``model_volume_bytes`` of the case's rows."""
    d, _, _ = runs
    z = np.load(d / "inputs.npz")
    dim, hidden, classes, depth = CASES[c]
    names = [f"{k}{i}" for k in "bw" for i in range(depth + 1)]
    params = {k: jnp.asarray(z[f"case{c}_{k}"]) for k in names}
    _, jloss, _ = jmodels.make_mlp_problem(dim, hidden, classes, depth)
    val, grads = jax.jit(jax.value_and_grad(jloss))(
        params, (jnp.asarray(z[f"case{c}_x"]), jnp.asarray(z[f"case{c}_y"])))
    got = [np.load(d / f"cases_{r}.npz") for r in (0, 1)]
    dims = [None if v < 0 else int(v) for v in got[0][f"case{c}_dims"]]
    assert dims == CASE_DIMS[c]
    assert got[0][f"case{c}_loss"] == got[1][f"case{c}_loss"]
    np.testing.assert_allclose(got[0][f"case{c}_loss"], float(val),
                               rtol=1e-5)
    for k, dim_k in zip(sorted(names), dims):
        blocks = [g[f"case{c}_{k}"] for g in got]
        whole = blocks[0] if dim_k is None else np.concatenate(blocks,
                                                                 dim_k)
        if dim_k is None:
            np.testing.assert_array_equal(blocks[0], blocks[1])
        np.testing.assert_allclose(whole, np.asarray(grads[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    tree = FlatTree.from_params({k: z[f"case{c}_{k}"] for k in names})
    want = tproto.model_volume_bytes(tproto._ProblemCfg(), 2, CASE_ROWS,
                                     tree=tree)
    assert set(want) == {"model", "model_loss"}
    for r in range(4):
        with open(d / f"cases_{r}.json") as fh:
            assert json.load(fh)[c] == want, r


def test_mlp_h1024_bytes_by_hand():
    """The layout and the bytes of ``mlp_h1024`` (dim 32, hidden 1024, 10
    classes) at M = 2, 25 rows: w0 on its output dim, w1 and w2 on their
    input dims, P_m = 547,850; over 'model' a group sends w1's [25, 1024]
    reduction, w2's [25, 512] input gradient and [25, 10] reduction, b0's
    gradient block and the L2 sum."""
    init, _, _ = tmodels.make_mlp_problem(32, 1024, 10, 2)
    tree = FlatTree.from_params(tproto.ProblemBundle(
        init, None).meta_params())
    split = tproto.model_split(tproto._ProblemCfg(), tree,
                               tmesh.Mesh(tmesh.AXES, (2, 1, 2)))
    assert split.dims == [None, None, None, 1, 0, 0]
    assert split.local.size == 547_850
    got = tproto.model_volume_bytes(tproto._ProblemCfg(), 2, 25,
                                    n_groups=2, tree=tree)
    per_group = 25 * 1024 * 4 + 25 * 512 * 4 + 25 * 10 * 4 + 512 * 4
    assert got == {"model": 2 * per_group, "model_loss": 2 * 4}
    pcfg = tproto.ProtocolConfig.derive(4, T=5)
    assert tproto.collective_volume_bytes(pcfg, 547_850, rep=2) == 8_765_600
    with pytest.raises(ValueError, match="needs its tree"):
        tproto.model_volume_bytes(tproto._ProblemCfg(), 2, 25)


# ---------------------------------------------------------------------------
# the protocol over ranks
# ---------------------------------------------------------------------------

NAMES = [run_name(*r) for r in RUNS]


@pytest.mark.parametrize("name", NAMES)
def test_protocol_matches_jax(runs, name):
    """The whole final params on every rank equal rank 0's, and are within
    rel-L2 1e-5 and rel-max 1e-4 of JAX's one-device protocol (per leaf)
    and of the port's one-rank run."""
    d, want, tree = runs
    _, engine, pull = name.split("_")
    one = np.load(d / f"one_{engine}_{pull}.npz")["params"]
    got = [_rank(d, name, r)[1]["params"] for r in range(4)]
    for r in range(1, 4):
        np.testing.assert_array_equal(got[r], got[0])
    for label, ref in (("jax", want[pull]), ("one rank", one)):
        l2, mx = _leaf_errors(got[0], ref, tree)
        print(f"{name} against {label}: rel-L2 {l2:.2e}, rel-max {mx:.2e}")
        assert l2 < REL_L2 and mx < REL_MAX, (label, l2, mx)


@pytest.mark.parametrize("name", NAMES)
def test_selections_and_accuracy_equal_one_rank(runs, name):
    """Every step's MDA weights on every rank equal the port's one-rank
    run's (the same support, weights to float32 rounding), and so does
    group 0's accuracy, which the engine reads from the whole replica
    outside the split form's rules."""
    d, _, _ = runs
    _, engine, pull = name.split("_")
    one = np.load(d / f"one_{engine}_{pull}.npz")
    for r in range(4):
        rec, arr = _rank(d, name, r)
        assert arr["sel"].shape[0] == STEPS == len(one["sel"])
        for a, b in zip(arr["sel"], one["sel"]):
            np.testing.assert_array_equal(a > 0, b > 0)
            np.testing.assert_allclose(a, b, rtol=1e-6)
        np.testing.assert_array_equal(rec["acc"], one["acc"])


@pytest.mark.parametrize("name", NAMES)
def test_bytes_match_the_formulas(runs, name):
    """Each rank's bytes on each step: 'model' and 'model_loss' equal
    ``model_volume_bytes`` of its groups and its 'fsdp' part of their
    rows, and no leaf is gathered whole ('model_leaves'); with the median
    pull, ``pull`` + ``aggregate`` equal ``collective_volume_bytes`` on
    the rank's columns of its blocks."""
    d, _, tree = runs
    shape, engine, pull = RUNS[NAMES.index(name)]
    rep, K, M = shape
    pcfg = tproto.ProtocolConfig.derive(G, T=T)
    tp = tproto.model_volume_bytes(tproto._ProblemCfg(), M, BATCH // K,
                                   n_groups=G // rep, tree=tree)
    P_m = tproto.model_split(tproto._ProblemCfg(), tree, tmesh.Mesh(
        tmesh.AXES, shape)).local.size
    assert P_m == 32 * 32 + 32 * 64 + 32 * 10 + 64 + 64 + 10
    for r in range(4):
        rec, _ = _rank(d, name, r)
        assert rec["P_m"] == P_m
        k0, k1 = rec["cols"]
        want = tproto.collective_volume_bytes(pcfg, k1 - k0, rep=rep)
        for i, sent in enumerate(rec["sent"]):
            assert "model_leaves" not in sent
            for tag, n in tp.items():
                assert sent[tag] == n, (r, i, tag, sent[tag], n)
            if pull == "median":
                got = sent.get("pull", 0) + sent.get("aggregate", 0)
                assert got == want, (r, i, got, want)


@pytest.mark.parametrize("name", NAMES)
def test_whole_leaves_equal_along_the_model_line(runs, name):
    """The biases (whole on every 'model' rank) hold the same bits on the
    two ranks of each 'model' line, and each rank's block of the split
    weights is its coordinate's block of the whole params."""
    d, _, tree = runs
    split0 = tproto.ModelSplit(tree, tproto.model_dims(tree, 2, None), 2, 0)
    spans = split0.local.spans()
    lines = {}
    for r in range(4):
        rec, arr = _rank(d, name, r)
        lines.setdefault(tuple(rec["coords"][:2]), []).append((rec, arr))
    for line in lines.values():
        (ra, a), (rb, b) = line
        assert ra["cols"] == rb["cols"] and ra["rows"] == rb["rows"]
        k0, k1 = ra["cols"]
        for d_i, (off, size) in zip(split0.dims, spans):
            lo, hi = max(off, k0), min(off + size, k1)
            if d_i is None and lo < hi:
                np.testing.assert_array_equal(a["block"][:, lo - k0:hi - k0],
                                              b["block"][:, lo - k0:hi - k0])
        for rec, arr in line:
            m = rec["coords"][2]
            r0, r1 = rec["rows"]
            cut = tproto.ModelSplit(tree, split0.dims, 2, m).cut(
                torch.from_numpy(arr["params"]))
            np.testing.assert_array_equal(arr["block"],
                                          cut[r0:r1, k0:k1].numpy())


def test_checkpoint_and_consolidate_at_2_1_2(runs):
    """A save of the (2, 1, 2) state restored on one rank (no mesh) is its
    whole stack bit for bit, and restored into the mesh each rank's block;
    ``consolidate`` on the mesh equals the one-card median of the whole
    stack, and with ``blocks`` its 'model' blocks."""
    d, _, _ = runs
    for r in range(4):
        ckpt = _records(d, r)["checkpoint"]
        assert ckpt["step"] == ckpt["t"] == STEPS
        assert ckpt["one_rank"] and ckpt["into_mesh"], (r, ckpt)
        assert ckpt["consolidate"] and ckpt["consolidate_blocks"], (r, ckpt)

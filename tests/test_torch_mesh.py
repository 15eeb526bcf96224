"""The port's rank meshes (``repro_torch.launch.mesh``) and the protocol on
a mesh, in one process: the ('rep', 'fsdp') choice against the reference's
rule, ``state_layout``'s ranges, the backend rule, the 'model' axis taken
by every family and by the paper's MLP problem and refused for a model
with neither, the elastic runner's segment meshes placed
as the reference places them (idle ranks refusing collectives), and
``ProtocolEngine(mesh=)``
on a world-1 gloo group bit-equal to the single-card engine. Also the
layernorm repair: the dense and MoE families with ``norm="layernorm"``
against JAX's forward and ``jax.grad`` on shared weights. The protocol on
several ranks is ``tests/test_torch_dist.py``."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_parity import CPU, jax_tree, numpy_params
from repro.launch.mesh import make_protocol_mesh as jax_protocol_mesh
from repro.models.registry import get_bundle as jax_bundle
from repro_torch import device as devmod
from repro_torch.configs import paper_models as tmodels
from repro_torch.core import attacks as tattacks
from repro_torch.core import protocol as tproto
from repro_torch.core.quorum import TraceDelivery
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import get_bundle
from repro_torch.optim import schedules as tsched


@pytest.mark.parametrize("G", range(1, 9))
def test_protocol_mesh_shape_follows_the_reference(G):
    """For every world of 1..8 ranks: the reference's ``(rep, fsdp,
    model)`` over that many devices."""
    d = jax.devices()[0]
    for world in range(1, 9):
        want = jax_protocol_mesh(G, devices=[d] * world).devices.shape
        assert tmesh.protocol_mesh_shape(G, world) == tuple(want), world
    with pytest.raises(ValueError, match="fsdp=3 needs"):
        tmesh.protocol_mesh_shape(4, 8, fsdp=3)


@pytest.mark.parametrize("world", range(1, 9))
@pytest.mark.parametrize("G", range(1, 9))
def test_segment_mesh_places_as_the_reference(G, world, monkeypatch):
    """The elastic runner's segment mesh of G groups on ``world`` ranks:
    its ranks are the reference's ``devices[:rep * K]`` in the same
    ``(rep, fsdp, 1)`` order (device ids standing for ranks), the rest
    idle; an idle rank has no coordinates or layout block, and each of its
    collectives raises."""
    import repro.launch.mesh as jmesh
    monkeypatch.setattr(jmesh, "_mk_mesh", lambda devs, axes: devs)
    want = np.asarray(jax_protocol_mesh(G, devices=list(range(world))))
    got = tmesh.segment_ranks(G, world)
    np.testing.assert_array_equal(got, want)
    for rank in range(world):
        m = tmesh.Mesh(tmesh.AXES, got.shape, rank=rank, world=world)
        assert m.member == (rank in want)
        if m.member:
            assert got[m.coords] == rank
            continue
        assert m.coords is None
        lay = tproto.state_layout(m, G, 10)
        assert (lay.rows, lay.cols) == ((0, G), (0, 0))
        x = torch.zeros(2, 3)
        for call in (lambda: m.all_gather(x, "rep", "t"),
                     lambda: m.all_to_all(x, "fsdp", "t"),
                     lambda: m.broadcast(x, "rep", "t"), m.barrier,
                     lambda: m.coord("rep")):
            with pytest.raises(RuntimeError, match="sits the mesh out"):
                call()
        assert sum(m.sent.values()) == 0


def test_state_layout_ranges():
    """Rows: G/rep at the 'rep' coordinate; columns: K near-equal
    contiguous ranges covering P."""
    P, G = 1001, 4
    seen = []
    for rank in range(8):
        m = tmesh.Mesh(tmesh.AXES, (4, 2, 1), rank=rank)
        lay = tproto.state_layout(m, G, P)
        assert lay.rows == (rank // 2, rank // 2 + 1)
        assert lay.bounds == (0, 500, 1001)
        assert lay.cols == (lay.bounds[rank % 2], lay.bounds[rank % 2 + 1])
        seen.append((lay.rows, lay.cols))
    assert len(set(seen)) == 8
    m = tmesh.Mesh(tmesh.AXES, (2, 3, 1), rank=5)
    lay = tproto.state_layout(m, 6, 10)
    assert lay.rows == (3, 6) and lay.bounds == (0, 3, 6, 10)
    assert lay.cols == (6, 10)
    assert tproto.state_layout(None, 4, 7) == ((0, 4), (0, 7), (0, 7))
    # a 'model' axis lays out the rank's flat row of blocks (P = P_m); the
    # rank view refuses a stack without its per-leaf split; every family
    # gets one (the MoE's experts split on F), and so does the paper's MLP
    # problem (the table's fallback); a model with neither gets none
    m2 = tmesh.Mesh(tmesh.AXES, (1, 1, 2), rank=1)
    assert tproto.state_layout(m2, 4, 7) == ((0, 4), (0, 7), (0, 7))
    with pytest.raises(ValueError, match="per-leaf split"):
        tproto.consolidate(torch.zeros(4, 7), tproto.ProtocolConfig.derive(4),
                           mesh=m2)
    moe = get_bundle("qwen3-moe-235b-a22b", reduced=True)
    tree = tproto.FlatTree.from_params(moe.init(torch.Generator()))
    split = tproto.model_split(moe.cfg, tree, m2)
    assert split.local.size < tree.size and split.m == 1
    w_gate = tree.paths.index(("blocks", "moe", "w_gate"))
    assert split.dims[w_gate] == 3
    with pytest.raises(NotImplementedError,
                       match="no tensor-parallel layers"):
        tproto.model_split(types.SimpleNamespace(name="mlp_h1024"), tree,
                           m2)
    mlp = _mlp()
    mtree = tproto.FlatTree.from_params(mlp.init(torch.Generator()))
    msplit = tproto.model_split(mlp.cfg, mtree, m2)
    # b0 b1 b2 whole; w0 [6, 8] on its output, w1 [8, 8] and w2 [8, 3] on
    # their inputs
    assert msplit.dims == [None, None, None, 1, 0, 0] and msplit.m == 1
    with pytest.raises(NotImplementedError, match="not an MLP's"):
        tproto.model_split(mlp.cfg, tree, m2)
    with pytest.raises(ValueError, match="must divide"):
        tproto.state_layout(tmesh.Mesh(tmesh.AXES, (3, 1, 1)), 4, 7)


def test_backend_rule_and_model_axis_refusals(monkeypatch):
    assert devmod.dist_backend(torch.device("cpu"), 8) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert devmod.dist_backend(torch.device("cuda"), 1) == "nccl"
    assert devmod.dist_backend(torch.device("cuda"), 2) == "gloo"
    base = tmesh.Mesh(("data", "model"), (4, 2))
    assert (base.dp_size, base.model_size) == (4, 2)
    moe = get_bundle("qwen3-moe-235b-a22b", reduced=True)
    smesh = tmesh.Mesh(("data", "model"), (4, 2))
    from repro_torch.launch.steps import serve_rules
    from repro_torch.models.registry import check_model_axis
    from repro_torch.serve import QuorumService, ReplicaPool
    pool = ReplicaPool.from_params(moe.init(torch.Generator()), 1)
    # every family takes the 'model' axis: a MoE service holds its blocks
    svc = QuorumService(pool, moe, rules=serve_rules(smesh, moe.cfg))
    assert svc.pool.sharded
    assert svc.pool.params["blocks"]["moe"]["w_gate"].shape[-1] == 256 // 2
    for arch in ("qwen3-moe-235b-a22b", "rwkv6-3b", "zamba2-1.2b",
                 "whisper-small"):
        check_model_axis(get_bundle(arch).cfg, 2)
    with pytest.raises(NotImplementedError,
                       match="no tensor-parallel layers"):
        tproto.model_split(types.SimpleNamespace(name="mlp"), None,
                           tmesh.Mesh(tmesh.AXES, (4, 1, 2)))
    check_model_axis(_mlp().cfg, 2)
    whisper = get_bundle("whisper-small", reduced=True)
    with pytest.raises(ValueError, match="token-in"):
        QuorumService(ReplicaPool.from_params(
            whisper.init(torch.Generator()), 1), whisper,
            rules=serve_rules(smesh, whisper.cfg))
    with pytest.raises(ValueError, match="256 ranks"):
        tmesh.make_production_mesh()
    # the MoE's --mesh 4x2 is taken; one rank cannot fill it
    with pytest.raises(SystemExit, match="needs 8 ranks"):
        train.main(["--arch", "qwen3-moe-235b-a22b", "--reduced", "--device",
                    "cpu", "--mesh", "4x2"])
    with pytest.raises(SystemExit, match="needs 4 ranks"):
        train.main(["--reduced", "--device", "cpu", "--mesh", "4x1"])
    m = tmesh.make_protocol_mesh(4)
    assert m.sizes == {"rep": 1, "fsdp": 1, "model": 1}


@pytest.fixture
def world1(tmp_path):
    """A world-1 gloo process group on a FileStore under ``tmp_path``, and
    one intra-op thread (both engines run in it; the suite's workers share
    the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    yield
    dist.destroy_process_group()
    torch.set_num_threads(threads)


T, STEPS = 2, 5                       # two gathers and a tail


def _tables(rng, G, q_w, q_ps):
    pull = np.stack([[rng.permutation(G)[:q_ps] for _ in range(G)]
                     for _ in range(STEPS)])
    push = np.stack([[rng.permutation(G)[:q_w] for _ in range(G)]
                     for _ in range(STEPS)])
    gather = np.stack([[np.concatenate([[r], rng.permutation(
        [s for s in range(G) if s != r])[:q_ps - 1]]) for r in range(G)]
        for _ in range(STEPS // T)])
    return pull, push, gather


def _mlp():
    init, loss, _ = tmodels.make_mlp_problem(6, 8, 3)
    return tproto.ProblemBundle(init=init, loss=loss)


@pytest.mark.parametrize("model,byz", [
    ("tfm", None), ("tfm", "alie"), ("mlp", None), ("mlp", "alie")])
def test_engine_on_world1_mesh_equals_single_card(world1, model, byz):
    """``ProtocolEngine(mesh=make_protocol_mesh(G))`` on a world-1 gloo
    group against ``ProtocolEngine()``: params bit-equal after 2T + 1
    steps on replayed tables (two DMC gathers), with and without an ALIE
    worker."""
    G = 5 if model == "mlp" else 4
    spec = tattacks.ByzantineSpec(worker_attack=byz,
                                  n_byz_workers=1 if byz else 0)
    pcfg = tproto.ProtocolConfig.derive(G, T=T, byz=spec)
    rng = np.random.default_rng(0)
    tables = _tables(rng, G, pcfg.q_workers, pcfg.q_servers)
    if model == "tfm":
        bundle = get_bundle("phi4-mini-3.8b", reduced=True,
                            act_dtype="float32")
        toks = rng.integers(0, bundle.cfg.vocab, (STEPS, G, 2, 9))
        batches = {"tokens": torch.from_numpy(toks[..., :-1]),
                   "labels": torch.from_numpy(toks[..., 1:])}
    else:
        bundle = _mlp()
        batches = (torch.from_numpy(rng.standard_normal(
            (STEPS, G, 5, 6)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 3, (STEPS, G, 5))))
    mesh = tmesh.make_protocol_mesh(G)
    assert mesh.backend == "gloo" and mesh.sizes["rep"] == 1
    ends = []
    for m in (None, mesh):
        eng = tproto.ProtocolEngine(
            bundle, pcfg, tsched.inverse_linear(0.05, 0.05),
            delivery=TraceDelivery(*tables, T=T, device="cpu"),
            with_attack=bool(byz), device="cpu", mesh=m)
        state, _ = eng.run(eng.init_state(0), batches)
        ends.append(state.params)
    assert torch.equal(ends[0], ends[1])
    assert not mesh.sent


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "qwen3-moe-235b-a22b"])
def test_layernorm_forward_and_grads_match_jax(arch):
    """``norm="layernorm"`` in the dense and MoE families (reduced, f32):
    init builds ``{"scale", "bias"}`` as the reference does,
    ``params_from_jax`` takes the tree, and the loss and every leaf's
    gradient match ``jax.value_and_grad`` on shared numpy weights (rtol
    1e-4, as ``tests/test_torch_moe.py``)."""
    over = dict(act_dtype="float32", norm="layernorm")
    jb = jax_bundle(arch, reduced=True, **over)
    tb = get_bundle(arch, reduced=True, **over)
    got = tb.init(torch.Generator().manual_seed(0))
    want = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
    assert sorted(got["ln_f"]) == sorted(want["ln_f"]) == ["bias", "scale"]
    assert sorted(got["blocks"]["ln_mlp"]) == ["bias", "scale"]
    p_np = numpy_params(jb.cfg, seed=21)
    rng = np.random.default_rng(22)
    toks = rng.integers(0, jb.cfg.vocab, (2, 25)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(toks[:, 1:])}
    tbatch = {k: torch.from_numpy(np.array(v)).long()
              for k, v in jbatch.items()}
    jl, jg = jax.value_and_grad(jb.loss)(jax_tree(p_np), jbatch)
    leaves = {}

    def track(t, path=""):
        if isinstance(t, dict):
            return {k: track(v, f"{path}/{k}") for k, v in t.items()}
        leaves[path] = t.requires_grad_()
        return t

    tp = track(params_from_jax(p_np, tb.cfg, device=CPU))
    tl = tb.loss(tp, tbatch)
    tl.backward()
    assert abs(float(tl) - float(jl)) < 1e-5
    for path, g in jax.tree_util.tree_flatten_with_path(jg)[0]:
        key = "".join(f"/{p.key}" for p in path)
        w = np.asarray(g)
        np.testing.assert_allclose(leaves[key].grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=key)
    bad = dict(p_np, ln_f={"scale": p_np["ln_f"]["scale"]})
    with pytest.raises(ValueError, match="ln_f/bias"):
        params_from_jax(bad, tb.cfg, device=CPU)

"""The 'model' axis's tables, in one process: the port's per-leaf split
dims of one architecture of each family against the reference's
``repro.core.protocol.leaf_spec`` (only the
column split of ``wq`` / ``wk`` / ``wv`` where the head counts divide M
may differ, ROADMAP.md Queue 3), ``ModelSplit``'s cut and join, and the
rule, parameter, cache and batch tables of ``repro_torch.launch.steps``.
The tensor-parallel runs are ``tests/test_torch_tp.py``."""
import types

import jax
import numpy as np
import pytest
import torch

from repro.core import protocol as jproto
from repro.models.registry import get_bundle as jax_bundle
from repro_torch.core import protocol as tproto
from repro_torch.core.simulator import FlatTree
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps
from repro_torch.models.registry import get_bundle

QKV = ("wq", "wk", "wv")
#: one architecture of each family
ARCHS = ["phi4-mini-3.8b", "qwen2-vl-7b", "qwen3-moe-235b-a22b", "rwkv6-3b",
         "zamba2-1.2b", "whisper-small"]


def _jax_leaves(arch, reduced):
    jb = jax_bundle(arch, reduced=reduced)
    shapes = jax.eval_shape(jb.init, jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return jb.cfg, [(tuple(str(p.key) for p in path), tuple(l.shape))
                    for path, l in flat]


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("M", [2, 16])
@pytest.mark.parametrize("reduced", [True, False],
                         ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_specs_follow_the_reference(arch, reduced, M, K):
    """Every replica-stacked leaf's spec at (rep 4, fsdp K, model M): the
    reference's, except ``wq`` / ``wk`` / ``wv``, which are the reference's
    ``leaf_spec`` under the port's overrides (column-parallel where the
    heads divide M); ``model_dims`` names the same 'model' dim."""
    cfg, leaves = _jax_leaves(arch, reduced)
    stand_in = types.SimpleNamespace(axis_names=("rep", "fsdp", "model"),
                                     devices=np.empty((4, K, M)))
    mesh = tmesh.Mesh(tmesh.AXES, (4, K, M))
    ref_over = jproto.attn_overrides(cfg, stand_in)
    over = tproto.attn_overrides(cfg, mesh)
    heads = (cfg.shared_attn_heads or cfg.n_heads) if cfg.family == \
        "hybrid" else cfg.n_heads
    assert over["wq"] == ("col" if heads % M == 0 else "row")
    tree = FlatTree([p for p, _ in leaves], [s for _, s in leaves])
    dims = tproto.model_dims(tree, M, over)
    specs = tproto.state_shardings(tree, mesh, over)
    differ = []
    for (path, shape), d, spec in zip(leaves, dims, specs):
        stacked = (4,) + shape
        if len(shape) == 0 or np.prod(shape) <= 2:
            assert d is None and spec == ()
            continue
        name = path[-1]
        got = tproto.leaf_spec(stacked, mesh, name=name, overrides=over)
        assert spec == got
        want = tuple(jproto.leaf_spec(stacked, stand_in, name=name,
                                      overrides=ref_over))
        if name in QKV:
            assert got == tuple(jproto.leaf_spec(stacked, stand_in,
                                                 name=name, overrides=over))
            differ += [name] if got != want else []
        else:
            assert got == want, (path, got, want)
        assert d == (got.index("model") - 1 if "model" in got else None)
    has_qkv = any(p[-1] == "wq" for p, _ in leaves)
    if cfg.n_kv_heads % M == 0 and has_qkv:
        assert sorted(set(differ)) == sorted(QKV)
    if cfg.n_heads % M or not has_qkv:
        assert not differ


@pytest.mark.parametrize("arch", ARCHS)
def test_port_tree_is_the_reference_tree(arch):
    """The reduced port model's leaves are the reference's, in order, so
    the two tables see the same leaves."""
    _, leaves = _jax_leaves(arch, True)
    tree = FlatTree.from_params(get_bundle(arch, reduced=True).init(
        torch.Generator()))
    assert list(zip(tree.paths, tree.shapes)) == leaves


@pytest.mark.parametrize("M", [2, 4])
def test_model_split_cut_and_join(M):
    """``cut`` at every coordinate then ``join`` gives the rows back;
    each coordinate's blocks tile the leaf; a leaf whole on every rank
    (the final norm) counts at coordinate 0 only."""
    b = get_bundle("phi4-mini-3.8b", reduced=True)
    tree = FlatTree.from_params(b.init(torch.Generator()))
    flat = torch.randn(3, tree.size)
    splits = [tproto.model_split(b.cfg, tree, tmesh.Mesh(
        tmesh.AXES, (1, 1, M), rank=m)) for m in range(M)]
    blocks = torch.stack([s.cut(flat) for s in splits])
    assert blocks.shape == (M, 3, splits[0].local.size)
    assert torch.equal(splits[0].join(blocks), flat)
    whole = [i for i, d in enumerate(splits[0].dims) if d is None]
    assert [tree.paths[i] for i in whole] == [("ln_f", "scale")]
    assert splits[0].owned() is None
    own = splits[1].owned()
    off, size = splits[1].local.spans()[whole[0]]
    assert own.sum() == splits[1].local.size - size
    assert not own[off:off + size].any()


def test_rule_tables():
    """``train_rules`` / ``serve_rules``: the batch over 'fsdp' / 'data';
    heads, kv heads, the vocab and the SwiGLU hidden over 'model' where
    they divide (full phi4-mini: 24 heads, 8 kv heads); the cache's chunk
    axis over 'model'; the residual stream whole."""
    cfg = get_bundle("phi4-mini-3.8b").cfg
    r = steps.train_rules(tmesh.Mesh(tmesh.AXES, (4, 2, 2)), cfg)
    assert r.table["act_btd"] == {"fsdp": 0}
    for name in ("act_heads", "act_kv_heads", "logits", "act_ffn"):
        assert r.table[name] == {"fsdp": 0, "model": 2}, name
    assert r.split("act_heads") and r.block(24) == (0, 12)
    s = steps.serve_rules(tmesh.Mesh(("data", "model"), (1, 16), rank=3),
                          cfg)
    assert not s.split("act_heads") and not s.split("act_kv_heads")
    assert s.split("logits") and s.split("kv_cache") and s.m == 3
    assert "data" not in s.table["logits"]
    q = steps.train_rules(tmesh.Mesh(tmesh.AXES, (1, 1, 4)), get_bundle(
        "phi4-mini-3.8b", reduced=True).cfg)
    assert q.split("act_heads") and not q.split("act_kv_heads")


def test_serve_param_cache_and_batch_tables():
    """ZeRO over 'data' only past 4 GB a rank after the model split
    (phi4-mini's 7.7 GB of bf16 at M = 2 is not, qwen2-vl-7b's 16.6 GB
    is); the cache's batch over 'data' and chunks over 'model'; a batch of
    one row stays whole; ``block`` cuts a rank's block."""
    smesh = tmesh.Mesh(("data", "model"), (2, 2), rank=3)
    for arch, zero in (("phi4-mini-3.8b", False), ("qwen2-vl-7b", True)):
        cfg, leaves = _jax_leaves(arch, False)
        tree = FlatTree([p for p, _ in leaves], [s for _, s in leaves])
        specs = steps.serve_param_sharding(tree, smesh, cfg)
        dims = tproto.model_dims(tree, 2, tproto.attn_overrides(cfg, 2))
        assert [s.get("model") for s in specs] == dims
        assert any("data" in s for s in specs) == zero, arch
    caches = types.SimpleNamespace(k=torch.zeros(2, 4, 8, 4, 16, 32))
    assert steps.cache_sharding(caches, smesh) == {
        "k": {"data": 1, "model": 3}, "v": {"data": 1, "model": 3},
        "length": {"data": 1}}
    assert steps.batch_sharding("tokens", (4, 16), smesh) == {"data": 0}
    assert steps.batch_sharding("positions", (3, 4, 16), smesh) == \
        {"data": 1}
    assert steps.batch_sharding("tokens", (1, 16), smesh) == {}
    x = torch.arange(32.).reshape(4, 8)
    assert torch.equal(steps.block(x, {"data": 0, "model": 1}, smesh),
                       x[2:, 4:])


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("M", [2, 16])
def test_body_and_replicaless_specs_follow_the_reference(M, K):
    """``body_spec`` and ``_replicaless_spec`` of every leaf of
    full-width phi4-mini, qwen2-vl-7b, qwen3-moe-235b-a22b, rwkv6-3b,
    zamba2-1.2b and whisper-small equal the reference's at (rep 4, fsdp K,
    model M)."""
    stand_in = types.SimpleNamespace(axis_names=("rep", "fsdp", "model"),
                                     devices=np.empty((4, K, M)))
    mesh = tmesh.Mesh(tmesh.AXES, (4, K, M))
    for arch in ARCHS:
        _, leaves = _jax_leaves(arch, False)
        for path, shape in leaves:
            assert tproto.body_spec(shape, mesh) == tuple(
                jproto.body_spec(shape, stand_in)), path
            assert tproto._replicaless_spec(shape, mesh) == tuple(
                jproto._replicaless_spec(shape, stand_in)), path

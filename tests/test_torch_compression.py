"""The port's gradient compression (``repro_torch.core.compression``)
against ``repro.core.compression`` on shared numpy gradients, and the
contract ``tests/test_compression.py`` holds the reference to: top-k's
sparsity and support, random-k unbiased, sign keeps the direction, MDA on
compressed gradients still excludes the Byzantine ones. random-k's kept
mask is replayed: the reference's Bernoulli draws are read back and handed
to the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro_torch import agg
from repro_torch.core import compression as tcomp


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (scale * rng.standard_normal((32, 16))).astype(np.float32),
            "b": (scale * rng.standard_normal(64)).astype(np.float32),
            "blk": {"u": (scale * rng.standard_normal((3, 5))
                          ).astype(np.float32)}}


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            {k: _both(v)[1] if isinstance(v, dict) else torch.from_numpy(v)
             for k, v in tree.items()})


def _assert_equal(jtree, ttree):
    for (path, j), t in zip(jax.tree_util.tree_flatten_with_path(jtree)[0],
                            [l for _, l in tcomp._leaves(ttree)]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=str(path))


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
def test_topk_matches_jax(frac):
    jt, tt = _both(_tree(0))
    _assert_equal(jcomp.topk_compress(jt, frac), tcomp.topk_compress(tt, frac))
    for l in tcomp.topk_compress(tt, 0.1).values():
        for _, leaf in tcomp._leaves(l):
            assert int((leaf != 0).sum()) <= int(leaf.numel() * 0.1) + 1


def test_randk_replayed_mask_matches_jax():
    """The reference's masks (``bernoulli(fold_in(key, i))`` leaf by leaf,
    in leaf order) handed to the port: equal outputs."""
    jt, tt = _both(_tree(1))
    key = jax.random.PRNGKey(3)
    want = jcomp.randk_compress(jt, key, frac=0.25)
    leaves, treedef = jax.tree.flatten(jt)
    masks = [np.asarray(jax.random.bernoulli(jax.random.fold_in(key, i), 0.25,
                                             l.shape))
             for i, l in enumerate(leaves)]
    keep = jax.tree.unflatten(treedef, masks)
    keep = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in keep.items()}
    _assert_equal(want, tcomp.randk_compress(tt, frac=0.25, keep=keep))


def test_randk_unbiased_and_needs_one_source():
    g = {"w": torch.ones(2048)}
    gen = torch.Generator().manual_seed(0)
    outs = [tcomp.randk_compress(g, gen, frac=0.25)["w"] for _ in range(64)]
    assert abs(float(torch.stack(outs).mean()) - 1.0) < 0.1
    with pytest.raises(ValueError, match="exactly one"):
        tcomp.randk_compress(g, frac=0.25)


def test_sign_matches_jax_and_keeps_direction():
    jt, tt = _both(_tree(2))
    got = tcomp.sign_compress(tt)
    want = jcomp.sign_compress(jt)
    for (_, j), (_, t) in zip(
            jax.tree_util.tree_flatten_with_path(want)[0],
            tcomp._leaves(got)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    dot = sum(float((a * b).sum()) for (_, a), (_, b)
              in zip(tcomp._leaves(tt), tcomp._leaves(got)))
    assert dot > 0
    assert set(tcomp.COMPRESSORS) == set(jcomp.COMPRESSORS)


def test_mda_on_compressed_still_excludes_byzantine():
    """MDA over 7 honest and 2 large Byzantine gradients, top-k compressed
    (frac 0.2): the aggregate keeps the honest scale."""
    rng = np.random.default_rng(4)
    honest = [rng.standard_normal(576).astype(np.float32) for _ in range(7)]
    byz = [500.0 * rng.standard_normal(576).astype(np.float32)] * 2
    stack = torch.from_numpy(np.stack(honest + byz))
    comp = tcomp.topk_compress({"g": stack}, frac=0.2)["g"]
    out = agg.get("mda")(comp, 2)
    assert float(torch.linalg.vector_norm(out)) < 50.0

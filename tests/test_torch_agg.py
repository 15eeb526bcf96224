"""The port's aggregators (all nine registry rules, masked and unmasked,
``tree_agg``) and the plain versions of the aggregation kernels (median,
trimmed mean, MeaMed, Gram, subset diameters) vs ``repro.agg`` and the JAX
Pallas kernels (interpret mode), on shared numpy stacks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.agg as jagg
import repro_torch.agg as agg
from repro.agg import rules as jrules
from repro.kernels.cwise_median.ops import cwise_median as jax_cwise_median
from repro_torch.agg import dispatch, rules
from repro_torch.kernels.cwise_median import ops
from repro_torch.kernels.cwise_median.ref import cwise_median_ref

BIG = 3.4e38


def _stack(n, shape, seed, nan_rows=0):
    x = np.random.default_rng(seed).standard_normal((n,) + shape)
    x = x.astype(np.float32)
    x[n - nan_rows:] = np.nan          # Byzantine NaN payloads
    return x


def _eq(got, want):
    """Exact equality (same order statistic, same f32 averaging)."""
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("n", [1, 3, 4, 5, 8])
@pytest.mark.parametrize("shape", [(7,), (2, 5)])
@pytest.mark.parametrize("nan_rows", [0, 1])
def test_median_matches_repro_agg(n, shape, nan_rows):
    f = (n - 1) // 2
    nan_rows = min(nan_rows, f)
    x = _stack(n, shape, n, nan_rows)
    got = agg.get("median")(torch.from_numpy(x), f)
    _eq(got, jagg.get("median")(jnp.asarray(x), f))
    assert got.shape == shape and got.dtype == torch.float32


@pytest.mark.parametrize("n", [4, 5, 7])
def test_median_host_and_tensor_masks_match_repro_agg(n):
    x = _stack(n, (3, 4), 10 + n, nan_rows=1)
    m = np.ones(n, bool)
    m[1] = False
    f = (int(m.sum()) - 1) // 2
    want = jagg.get("median")(jnp.asarray(x), f, mask=m)      # concrete
    _eq(agg.get("median")(torch.from_numpy(x), f, mask=m), want)
    # a tensor mask takes the masked (sort-trick) path, as a traced JAX mask
    _eq(agg.get("median")(torch.from_numpy(x), f, mask=torch.from_numpy(m)),
        jrules.masked_coordinate_median(jnp.asarray(x), jnp.asarray(m)))


@pytest.mark.parametrize("n", [3, 4, 5])
@pytest.mark.parametrize("masked", [False, True])
def test_vote_matches_repro_agg(n, masked):
    x = np.random.default_rng(n).integers(0, 3, size=(n, 4, 6)).astype(np.int32)
    m = np.ones(n, bool)
    if masked:
        m[0] = False
    f = (int(m.sum()) - 1) // 2
    want = jagg.get("vote")(jnp.asarray(x), f, mask=m if masked else None)
    got = agg.get("vote")(torch.from_numpy(x), f, mask=m if masked else None)
    _eq(got, want)
    _eq(agg.get("vote")(torch.from_numpy(x), f, mask=torch.from_numpy(m)),
        jrules.masked_vote(jnp.asarray(x), jnp.asarray(m)))


def test_breakdown_and_mask_validation_match():
    x = torch.zeros((3, 2))
    with pytest.raises(ValueError, match="2f\\+1"):
        agg.get("median")(x, 2)
    with pytest.raises(ValueError, match="mask must be"):
        agg.get("median")(x, 1, mask=np.ones(4, bool))
    with pytest.raises(ValueError, match="requires n >= 2f"):
        agg.get("vote")(x, 1, mask=np.array([True, True, False]))
    assert agg.names() == jagg.names()
    for name in agg.names():
        mine, ref = agg.get(name), jagg.get(name)
        for key in ("requires", "breakdown", "tree_mode", "tunables",
                    "selection_based", "supports_masked_delivery"):
            assert getattr(mine, key) == getattr(ref, key), (name, key)
        if ref.variance_threshold is not None:
            assert mine.variance_threshold(18, 2) == \
                ref.variance_threshold(18, 2)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 7, 8, 33, 64])
def test_plain_kernel_matches_pallas_kernel(n):
    """The kernel's plain version (the ``_tile`` contract + sort) vs the
    Pallas kernel in interpret mode, one NaN row included."""
    x = _stack(n, (300,), n, nan_rows=1)
    got = ops.cwise_median(torch.from_numpy(x))
    _eq(got, jax_cwise_median(jnp.asarray(x), interpret=True))


@pytest.mark.parametrize("n", [3, 5])
def test_majority_nan_odd_n_documented_difference(n):
    """Odd n with _BIG at the middle rank: the Pallas kernel's
    0.5 * (row + row) overflows to inf; the port returns _BIG, as
    ``repro.agg.rules.median_stack`` (the serving read's reference) does."""
    x = _stack(n, (16,), 3, nan_rows=n // 2 + 1)
    got = ops.cwise_median(torch.from_numpy(x)).numpy()
    assert np.all(got == np.float32(BIG))
    assert np.all(np.isinf(np.asarray(
        jax_cwise_median(jnp.asarray(x), interpret=True))))
    _eq(got, jrules.median_stack(jnp.asarray(x)))


def test_tile_contract():
    x = torch.tensor([[1.0, float("nan")], [2.0, 3.0], [0.5, -1.0]])
    xp, n_pow2 = ops._tile(x)
    assert n_pow2 == 4 and xp.shape == (4, 2) and xp.dtype == torch.float32
    assert xp[0, 1] == BIG and torch.all(xp[3] == BIG)
    with pytest.raises(ValueError, match="n <= 64"):
        ops._tile(torch.zeros((65, 2)))


def test_dispatch_views_stacks_as_2d_and_falls_back_past_64():
    x = torch.from_numpy(_stack(4, (2, 3, 5), 7))
    _eq(dispatch.cwise_median(x), rules.median_stack(x))
    big = torch.from_numpy(_stack(70, (9,), 8))
    _eq(dispatch.cwise_median(big), rules.coordinate_median(big))
    _eq(dispatch.cwise_median(big), cwise_median_ref(big))


def test_cpu_runs_plain_version_and_no_silent_fallback():
    before = ops.cwise_median.launches
    ops.cwise_median(torch.zeros((4, 8)))
    assert ops.cwise_median.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        ops.cwise_median(torch.empty((4, 8), device="meta"))



# -- every registry rule, the tree path, the training slice's kernels ---------

def _max_f(spec, n):
    return max(f for f in range(0, 3) if n >= spec.requires[0] * f
               + spec.requires[1] and f < n)


@pytest.mark.parametrize("name", jagg.names())
@pytest.mark.parametrize("n", [5, 6, 7])
@pytest.mark.parametrize("mask", [None, "host", "tensor"])
def test_every_rule_matches_repro_agg(name, n, mask):
    """Each rule at its largest admissible f (<= 2), a Byzantine NaN payload
    in the last row when f >= 1; a host mask takes the delivered subset, a
    tensor mask the masked implementation (as a traced JAX mask)."""
    import jax
    spec, jspec = agg.get(name), jagg.get(name)
    m = np.ones(n, bool)
    m[1] = False
    f = _max_f(jspec, n - (mask is not None))
    x = _stack(n, (12,), 3 * n + f, nan_rows=min(f, 1))
    if name == "vote":
        x = np.nan_to_num(np.round(x)).astype(np.int32)
    if mask == "tensor" and not jspec.supports_masked_delivery:
        with pytest.raises(ValueError, match="tensor-mask"):
            spec(torch.from_numpy(x), f, mask=torch.from_numpy(m))
        return
    if mask is None:
        want = jspec(jnp.asarray(x), f)
        got = spec(torch.from_numpy(x), f)
    elif mask == "host":
        want = jspec(jnp.asarray(x), f, mask=m)
        got = spec(torch.from_numpy(x), f, mask=m)
    else:
        want = jax.jit(lambda a, b: jspec(a, f, mask=b))(jnp.asarray(x),
                                                         jnp.asarray(m))
        got = spec(torch.from_numpy(x), f, mask=torch.from_numpy(m))
    # float32 sums in other orders (XLA vs PyTorch); every selection equal
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=2e-6, equal_nan=True)


def _mlp_stack(n, seed):
    rng = np.random.default_rng(seed)
    shapes = {"w0": (6, 8), "b0": (8,), "w1": (8, 8), "b1": (8,),
              "w2": (8, 3), "b2": (3,)}
    return {k: rng.standard_normal((n,) + s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("name", ["mda", "krum", "multi_krum", "median",
                                  "meamed", "trimmed_mean", "mean"])
def test_tree_agg_flat_stack_matches_jax_pytree(name):
    """JAX aggregates the MLP dict leaf by leaf (selection rules from summed
    per-leaf Grams); the port aggregates one flat [n, D] stack in JAX leaf
    order, and a batch of stacks [B, n, D] in one call."""
    from repro.agg import tree as jtree
    from repro_torch.core.simulator import FlatTree
    n, f = 7, (2 if name != "mean" else 0)
    stacks = [_mlp_stack(n, s) for s in range(3)]
    tree = FlatTree.from_params(stacks[0], lead=1)
    flat = torch.stack([tree.flatten(
        {k: torch.from_numpy(v) for k, v in s.items()}, lead=1)
        for s in stacks])
    got = agg.tree_agg(name, flat, f)                    # [3, D], batched
    for b, s in enumerate(stacks):
        want = jtree.tree_agg(name, {k: jnp.asarray(v) for k, v in s.items()},
                              f)
        want = np.concatenate([np.asarray(want[k]).ravel()
                               for k in sorted(want)])
        np.testing.assert_allclose(got[b].numpy(), want, rtol=2e-6,
                                   atol=2e-6)
        np.testing.assert_array_equal(
            agg.tree_agg(name, flat[b], f).numpy(), got[b].numpy())
    as_dict = agg.tree_agg(name, {k: torch.from_numpy(v)
                                  for k, v in stacks[0].items()}, f)
    assert as_dict["w1"].shape == (8, 8)
    np.testing.assert_array_equal(tree.flatten(as_dict).numpy(),
                                  got[0].numpy())
    gram = agg.tree_gram(flat)
    np.testing.assert_allclose(gram[0].numpy(), np.asarray(
        jtree.tree_gram({k: jnp.asarray(v) for k, v in stacks[0].items()})),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [2, 3, 5, 7, 8, 16])
@pytest.mark.parametrize("f", [0, 1, 2])
def test_trimmed_mean_and_meamed_plain_match_pallas_kernels(n, f):
    """The kernels' plain versions (the port's CPU route) vs the Pallas
    kernels in interpret mode, f NaN payload rows included. The plain
    versions repeat the window scan in the Pallas kernel's order; XLA may
    fold a division into a product, so equal to float32 rounding."""
    from repro.kernels.cwise_median.ops import (cwise_meamed,
                                                cwise_trimmed_mean)
    x = _stack(n, (300,), 11 * n + f, nan_rows=min(f, n - 1))
    if n > 2 * f:
        np.testing.assert_allclose(
            ops.cwise_trimmed_mean(torch.from_numpy(x), f).numpy(),
            np.asarray(cwise_trimmed_mean(jnp.asarray(x), f,
                                          interpret=True)),
            rtol=1e-6, atol=1e-6)
    if n > f and f >= min(f, n - 1) and n > 2 * f:
        np.testing.assert_allclose(
            ops.cwise_meamed(torch.from_numpy(x), f).numpy(),
            np.asarray(cwise_meamed(jnp.asarray(x), f, interpret=True)),
            rtol=1e-6, atol=1e-6)


def test_batched_order_statistics_are_per_stack():
    x = torch.from_numpy(_stack(4, (3, 50), 5, nan_rows=1))
    for fn, args in ((ops.cwise_median, ()), (ops.cwise_trimmed_mean, (1,)),
                     (ops.cwise_meamed, (1,))):
        xb = x.reshape(1, 4, 150).expand(3, 4, 150)
        got = fn(xb, *args)
        assert got.shape == (3, 150)
        _eq(got[2], fn(x.reshape(4, 150), *args))
    _eq(dispatch.meamed(x.expand(2, 4, 3, 50), 1, batched=True)[1],
        dispatch.meamed(x, 1))


def test_meamed_asymmetric_ties_match_reference():
    """Colluding duplicate payloads tie several windows on the max endpoint
    distance; the plain kernel version picks the reference's window (as
    tests/test_agg_backends.py holds the Pallas kernel)."""
    col = np.asarray([0., -3., 0., 0., 1., -3., -3., -1., -3., 1.],
                     np.float32)[:, None]
    want = jrules.meamed(jnp.asarray(col), 3)
    np.testing.assert_allclose(ops.cwise_meamed(torch.from_numpy(col),
                                                3).numpy(),
                               np.asarray(want), rtol=1e-6, atol=1e-6)


def test_meamed_tie_quality_on_integer_stacks():
    """On tie-heavy integer stacks the kernel contract holds: the selected
    window has the reference's max distance and distance sum, and its mean
    is the lexicographic (max, sum) best window's."""
    rng = np.random.default_rng(0)
    for it in range(40):
        n = int(rng.integers(3, 14))
        f = int(rng.integers(0, (n - 1) // 2 + 1))
        x = np.asarray(rng.integers(-3, 4, size=(n, 8)), np.float32)
        got = ops.cwise_meamed(torch.from_numpy(x), f).numpy()
        if it < 5:      # the Pallas kernel compiles once per (n, f)
            pallas = np.asarray(jagg.get("meamed")(jnp.asarray(x), f,
                                                   backend="pallas"))
            np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)
        m = n - f
        med = np.median(x, axis=0)
        for c in range(x.shape[1]):
            d_ref = np.sort(np.abs(x[:, c] - med[c]))[:m]
            s = np.sort(x[:, c])
            cand = [(max(abs(s[i] - med[c]), abs(s[i + m - 1] - med[c])),
                     np.abs(s[i:i + m] - med[c]).sum(), s[i:i + m].mean())
                    for i in range(f + 1)]
            kmax, ksum, kmean = min(cand, key=lambda t: (t[0], t[1]))
            assert kmax == pytest.approx(d_ref.max(), abs=1e-5)
            assert ksum == pytest.approx(d_ref.sum(), abs=1e-4)
            assert got[c] == pytest.approx(kmean, abs=1e-5)


@pytest.mark.parametrize("n,d", [(3, 100), (7, 1000), (9, 2500), (64, 130)])
def test_gram_plain_matches_pallas_kernel(n, d):
    from repro.kernels.pairwise_sqdist import ops as jgram
    from repro_torch.kernels.pairwise_sqdist import ops as gram_ops
    x = _stack(n, (d,), n + d)
    got = gram_ops.gram(torch.from_numpy(x)).numpy()
    want = np.asarray(jgram.gram(jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        gram_ops.pairwise_sqdists(torch.from_numpy(x)).numpy(),
        np.asarray(jgram.pairwise_sqdists(jnp.asarray(x), interpret=True)),
        rtol=1e-5, atol=1e-3)
    chunk, n_chunks = gram_ops.chunking(1, d)
    assert chunk % gram_ops.TILE == 0 and (n_chunks - 1) * chunk < d


@pytest.mark.parametrize("n,f", [(5, 1), (7, 2), (9, 3)])
def test_subset_diameters_plain_matches_pallas_kernel(n, f):
    """Exact, NaN included; masks in itertools.combinations order."""
    from repro.kernels.mda_diameter import ops as jdiam
    from repro_torch.kernels.mda_diameter import ops as diam_ops
    d2 = _stack(n, (n,), n * f) ** 2
    d2[2, 3] = np.nan
    masks = rules.subset_masks(n, f)
    np.testing.assert_array_equal(masks, jrules.subset_masks(n, f))
    got = diam_ops.subset_diameters(torch.from_numpy(d2), masks).numpy()
    want = np.asarray(jdiam.subset_diameters(jnp.asarray(d2),
                                             jnp.asarray(masks),
                                             interpret=True))
    np.testing.assert_array_equal(got, want)
    bits = diam_ops.bitmasks(masks, "cpu").numpy().view(np.uint64)
    assert [int(b) for b in bits[:2]] == [
        sum(1 << i for i in np.flatnonzero(row)) for row in masks[:2]]


def test_exact_mda_takes_the_first_minimum():
    """Tied diameters: both packages select the first subset in enumeration
    order."""
    x = np.zeros((5, 4), np.float32)
    x[:, 0] = [0.0, 1.0, 2.0, 3.0, 4.0]
    d2 = rules.pairwise_sqdists(torch.from_numpy(x))
    for fn in (rules.subset_diameters, dispatch.subset_diameters):
        sel = rules.mda_select_exact(d2, 1, diameters_fn=fn)
        want = jrules.mda_select_exact(jnp.asarray(d2.numpy()), 1)
        np.testing.assert_array_equal(sel.numpy(), np.asarray(want))
    assert sel.tolist() == [True, True, True, True, False]


def test_greedy_mda_matches_jax():
    x = _stack(9, (20,), 4)
    d2 = jrules.pairwise_sqdists(jnp.asarray(x))
    got = rules.mda_select_greedy(torch.from_numpy(np.asarray(d2)), 3)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jrules.mda_select_greedy(d2, 3)))
    got = agg.get("mda")(torch.from_numpy(x), 3, exact_limit=10)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jagg.get("mda")(jnp.asarray(x), 3, exact_limit=10)), rtol=2e-6,
        atol=2e-6)


def test_new_kernels_cpu_route_and_past_64():
    """CPU tensors run the plain versions (no launch counted); a device the
    kernels do not take raises; stacks past 64 run the plain rules."""
    from repro_torch.kernels.mda_diameter import ops as diam_ops
    from repro_torch.kernels.pairwise_sqdist import ops as gram_ops
    before = (ops.cwise_meamed.launches, ops.cwise_trimmed_mean.launches,
              gram_ops.gram.launches, diam_ops.subset_diameters.launches)
    x = torch.from_numpy(_stack(7, (33,), 1))
    agg.get("mda")(x, 2)
    agg.get("meamed")(x, 2)
    agg.get("trimmed_mean")(x, 2)
    assert before == (ops.cwise_meamed.launches,
                      ops.cwise_trimmed_mean.launches,
                      gram_ops.gram.launches,
                      diam_ops.subset_diameters.launches)
    meta = torch.empty((4, 8), device="meta")
    for fn in (lambda t: ops.cwise_meamed(t, 1), gram_ops.gram,
               lambda t: diam_ops.subset_diameters(
                   torch.empty((4, 4), device="meta"),
                   rules.subset_masks(4, 1))):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(meta)
    big = torch.from_numpy(_stack(70, (9,), 8))
    _eq(dispatch.meamed(big, 3), rules.meamed(big, 3))
    _eq(dispatch.trimmed_mean(big, 3), rules.trimmed_mean(big, 3))
    np.testing.assert_allclose(dispatch.pairwise_sqdists(big).numpy(),
                               rules.pairwise_sqdists(big).numpy())

"""Port's serving aggregators (median, vote; masked and unmasked) and the
coordinate-wise median kernel's plain version vs ``repro.agg`` and the JAX
Pallas kernel (interpret mode), on shared numpy stacks."""
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
    assert agg.names() == ("median", "vote")
    for name in agg.names():
        assert agg.get(name).requires == jagg.get(name).requires
        assert agg.get(name).breakdown == jagg.get(name).breakdown


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


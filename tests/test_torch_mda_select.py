"""Exact MDA selection in one launch (``repro_torch.kernels.mda_diameter``):
the plain version of the selection kernel — the subset diameters, their
first argmin and the averaging weights — against
``repro.agg.rules.mda_select_exact`` driven through the Pallas diameter
kernel in interpret mode, on shared numpy distances; and its routes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import elsewhere
from repro.agg import rules as jrules
from repro.kernels.mda_diameter import ops as jdiam
from repro_torch.agg import dispatch, rules
from repro_torch.kernels.mda_diameter import ops as diam_ops

CASES = [(3, 1), (5, 1), (5, 2), (7, 2), (9, 3)]


def _pallas_diameters(d2, masks):
    return jdiam.subset_diameters(d2, masks, interpret=True)


def _distances(kind: str, n: int, seed: int) -> np.ndarray:
    """``[3, n, n]`` float32 squared distances of three receivers: of random
    points ("random"), of integer points on a line, so that many subsets tie
    on their diameter ("ties"), or random with one NaN entry ("nan")."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        x = rng.integers(0, 4, size=(3, n, 1)).astype(np.float32)
    else:
        x = rng.standard_normal((3, n, 5)).astype(np.float32)
    d2 = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
    if kind == "nan":
        d2[1, 0, n - 1] = np.nan
    return d2.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ties", "nan"])
@pytest.mark.parametrize("n,f", CASES)
def test_mda_select_plain_matches_pallas_selection(n, f, kind):
    """Diameters exact (NaN where a subset holds the NaN pair); weights
    exactly the JAX selection's mask over n - f, the first minimum in
    enumeration order (the first NaN when there is one), and exactly the
    weights of the rules' route."""
    d2 = _distances(kind, n, 10 * n + f)
    diam, w = diam_ops.mda_select(torch.from_numpy(d2), f)
    masks = jnp.asarray(jrules.subset_masks(n, f))
    for b in range(d2.shape[0]):
        want_diam = np.asarray(_pallas_diameters(jnp.asarray(d2[b]), masks))
        np.testing.assert_array_equal(diam[b].numpy(), want_diam)
        sel = jrules.mda_select_exact(jnp.asarray(d2[b]), f,
                                      diameters_fn=_pallas_diameters)
        want_w = np.asarray(sel).astype(np.float32) / np.float32(n - f)
        np.testing.assert_array_equal(w[b].numpy(), want_w)
        if kind == "nan" and b == 1:
            assert np.isnan(want_diam).any()
            first = int(np.flatnonzero(np.isnan(want_diam))[0])
            assert np.array_equal(np.asarray(sel), np.asarray(masks[first]))
    assert w.dtype == torch.float32
    assert torch.equal(w, rules.mda_weights_from_d2(torch.from_numpy(d2), f))


def test_mda_select_ties_take_the_first_subset():
    """Equal diameters (points 0..4 on a line, f = 1: {0..3} and {1..4}
    both span 9): the first in enumeration order."""
    x = torch.arange(5, dtype=torch.float32)[:, None]
    d2 = rules.pairwise_sqdists(x)
    diam, w = diam_ops.mda_select(d2, 1)
    assert diam.tolist() == [9.0, 16.0, 16.0, 16.0, 9.0]
    assert w.tolist() == [0.25, 0.25, 0.25, 0.25, 0.0]


def test_mda_select_shapes_and_routes():
    """[n, n] -> ([S], [n]); a CPU tensor runs the plain version (no launch);
    a device the kernel does not take raises; the dispatch's CPU route stays
    the rules'; f outside 0 <= f < n raises."""
    d2 = torch.from_numpy(_distances("random", 7, 1))
    before = diam_ops.subset_diameters.launches
    diam, w = diam_ops.mda_select(d2[0], 2)
    assert diam.shape == (21,) and w.shape == (7,)
    assert torch.equal(w, diam_ops.mda_select_plain(d2, 2)[1][0])
    assert torch.equal(dispatch.mda_weights_from_d2(d2, 2),
                       rules.mda_weights_from_d2(d2, 2))
    assert diam_ops.subset_diameters.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        diam_ops.mda_select(elsewhere((4, 4)), 1)
    with pytest.raises(ValueError, match="0 <= f < n"):
        diam_ops.mda_select(d2, 7)


def test_subset_enumeration_is_shared_with_the_rules():
    """One enumeration: the rules' masks are the kernel package's, and equal
    the JAX package's."""
    assert rules.subset_masks is diam_ops.subset_masks
    for n, f in CASES:
        np.testing.assert_array_equal(rules.subset_masks(n, f),
                                      jrules.subset_masks(n, f))
        assert rules.n_subsets(n, f) == jrules.n_subsets(n, f)

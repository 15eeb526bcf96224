"""Queue 1 item 16: ``repro_torch.agg.aggregate``,
``core.filters.lipschitz_pass`` and ``core.quorum``'s draws and
``DeliveryModel``, against the reference where the inputs are shared, and
the draws against the contract of ``tests/test_quorum_attacks_filters.py``
(torch draws cannot replay threefry: q distinct senders, the receiver's own
index under ``include_self``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.agg as jagg
from repro.core import filters as jfilters
from repro_torch import agg
from repro_torch.core import filters, quorum


@pytest.mark.parametrize("rule", ["median", "krum", "mda", "trimmed_mean",
                                  "meamed", "bulyan"])
def test_aggregate_matches_the_reference(rule):
    """``aggregate(rule, x, f)`` on one shared ``[11, 40]`` stack equals
    the reference's ``aggregate`` (rtol 1e-5), by name and by spec."""
    x = np.random.default_rng(5).standard_normal((11, 40)).astype(np.float32)
    want = np.asarray(jagg.aggregate(rule, jnp.asarray(x), 2))
    got = agg.aggregate(rule, torch.from_numpy(x), 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert torch.equal(agg.aggregate(agg.get(rule), torch.from_numpy(x), 2),
                       got)


@pytest.mark.parametrize("hist", [[], [1.0, 1.1, 0.9, 1.05],
                                  [0.5, 3.0, 2.0, 1.0, 7.0, 4.0, 6.0, 5.0]])
def test_lipschitz_pass_matches_the_reference(hist):
    """The same history pushed into both buffers and the same candidate
    coefficients: the same verdicts (an empty history accepts)."""
    jh = jfilters.LipschitzHistory.create(8)
    th = filters.LipschitzHistory.create(1, 8)
    for v in hist:
        jh = jh.push(jnp.float32(v))
        th = th.push(torch.tensor([v], dtype=torch.float32))
    for k in (0.5, 1.0, 1.07, 4.0, 50.0):
        want = bool(jfilters.lipschitz_pass(jnp.float32(k), jh, 4, 1))
        got = filters.lipschitz_pass(torch.tensor([k]), th, 4, 1)
        assert bool(got[0]) == want, (hist, k)


@pytest.mark.parametrize("seed", range(4))
def test_quorum_draws_keep_the_contract(seed):
    """``sample_quorum_mask`` has exactly q True, ``include`` among them;
    ``receiver_quorum_masks`` rows likewise, the diagonal under
    ``include_self``; ``sample_quorum_indices`` q distinct indices with
    ``include``; ``full_quorum`` all True."""
    gen = torch.Generator().manual_seed(seed)
    for n, q in ((6, 3), (9, 5), (4, 4)):
        m = quorum.sample_quorum_mask(gen, n, q)
        assert m.dtype == torch.bool and int(m.sum()) == q
        m = quorum.sample_quorum_mask(gen, n, q, include=n - 1)
        assert int(m.sum()) == q and bool(m[n - 1])
        idx = quorum.sample_quorum_indices(gen, n, q, include=1)
        assert len(set(idx.tolist())) == q and 1 in idx.tolist()
    masks = quorum.receiver_quorum_masks(gen, 6, 6, 3, include_self=True)
    assert masks.sum(1).tolist() == [3] * 6
    assert bool(masks.diagonal().all())
    masks = quorum.receiver_quorum_masks(gen, 5, 9, 6)
    assert masks.shape == (5, 9) and masks.sum(1).tolist() == [6] * 5
    assert bool(quorum.full_quorum(3, 4).all())
    assert quorum.full_quorum(3, 4).shape == (3, 4)


def test_delivery_models_satisfy_the_protocol():
    """Both delivery models are ``DeliveryModel``s; an object without
    ``gather_indices`` is not."""
    assert isinstance(quorum.UniformDelivery(4, 4, 3, 3),
                      quorum.DeliveryModel)
    tables = np.zeros((2, 4, 3), np.int32)
    assert isinstance(quorum.TraceDelivery(tables, tables, tables[:1], T=2,
                                           device="cpu"),
                      quorum.DeliveryModel)

    class Partial:
        def pull_indices(self, gen, t, device=None):
            return None

    assert not isinstance(Partial(), quorum.DeliveryModel)

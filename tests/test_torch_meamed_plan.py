"""MeaMed's kernel design, checked without the card: the launch plan
(``cwise_median.ops.meamed_plan``), and the sorted column the exact-n kernel
scans. For n <= 16 ``cwise_median.cu`` sorts on exactly n wires — Batcher's
odd-even network with every compare-exchange on a pad wire dropped — and
then restores what the pads do to values above ``_BIG``; a model of that in
plain PyTorch must give the plain version's padded sorted rows bit for
bit."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.cwise_median import ops
from repro_torch.kernels.cwise_median.ref import _BIG, _oddeven_pairs


@pytest.mark.parametrize("n,d,ptr,want", [
    (5, 1_093_642, 0, ("exact", 5, 2)),       # sync_filters' refresh
    (5, 1_093_643, 0, ("exact", 5, 1)),       # odd d: rows off 8 bytes
    (5, 1000, 4, ("exact", 5, 1)),            # a view 4 bytes off
    (1, 2, 8, ("exact", 1, 2)),
    (16, 6, 16, ("exact", 16, 2)),
    (17, 10, 0, ("padded", 32, 1)),
    (32, 10, 0, ("padded", 32, 1)),
    (33, 10, 0, ("padded", 64, 1)),
    (64, 4, 0, ("padded", 64, 1))])
def test_meamed_launch_plan(n, d, ptr, want):
    """The exact-n kernel up to 16 rows, two columns a thread where every
    row starts 8-byte aligned; the padded kernel past 16, one column."""
    plan = ops.meamed_plan(n, d, ptr)
    assert tuple(plan) == want
    assert plan.path == ("exact" if n <= ops.MAX_EXACT_N else "padded")


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@pytest.mark.parametrize("n", range(1, 17))
def test_exact_network_is_the_padded_one_without_pad_wires(n):
    """The odd-even network on n wires is the power-of-two network with each
    compare-exchange that touches a wire >= n dropped, and it sorts every
    0-1 input (so every input)."""
    full = _oddeven_pairs(_pow2(n)) if n > 1 else ()
    assert _oddeven_pairs(n) == tuple(p for p in full if p[1] < n)
    bits = ((np.arange(2 ** n)[:, None] >> np.arange(n)) & 1).astype(bool)
    for i, j in _oddeven_pairs(n):
        lo, hi = bits[:, i] & bits[:, j], bits[:, i] | bits[:, j]
        bits[:, i], bits[:, j] = lo, hi
    assert not (bits[:, :-1] & ~bits[:, 1:]).any()


def _exact_rows(x: torch.Tensor) -> torch.Tensor:
    """What ``meamed_exact_kernel<n>`` scans: NaN to _BIG, the network on n
    wires, then row j of the merge with pow2(n) - n copies of _BIG:
    max(r[j - c], min(r[j], _BIG)), min(r[j], _BIG) for j < c."""
    n = x.shape[0]
    r = list(torch.where(torch.isnan(x), _BIG, x).unbind(0))
    for i, j in _oddeven_pairs(n):
        r[i], r[j] = torch.minimum(r[i], r[j]), torch.maximum(r[i], r[j])
    big = torch.tensor(_BIG, dtype=torch.float32)
    c = _pow2(n) - n
    for j in reversed(range(n)):
        top = torch.minimum(r[j], big)
        r[j] = torch.maximum(r[j - c], top) if j >= c else top
    return torch.stack(r)


@pytest.mark.parametrize("n", range(1, 17))
def test_exact_rows_equal_the_padded_sort(n):
    """+inf, -inf, values between 3.4e38 and FLT_MAX, NaN payloads and
    integer ties: the kernel's n rows equal the plain version's first n
    padded sorted rows, so its scan (the same arithmetic) gives the same
    MeaMed."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 4000)).astype(np.float32)
    x[:, 2000:] = rng.integers(-2, 3, size=(n, 2000))
    u = rng.random((n, 4000))
    x[u < 0.1] = np.inf
    x[(u >= 0.1) & (u < 0.15)] = np.nan
    x[(u >= 0.15) & (u < 0.2)] = -np.inf
    x[(u >= 0.2) & (u < 0.25)] = np.float32(3.4028e38)
    x[(u >= 0.25) & (u < 0.3)] = np.float32(_BIG)
    xt = torch.from_numpy(x)
    assert torch.equal(_exact_rows(xt), ops._sorted_rows(xt)[:n])

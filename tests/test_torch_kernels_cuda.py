"""The CUDA kernels on the card: each against its plain PyTorch version at
shapes of the serving and training paths (the batched median, trimmed
mean, MeaMed, Gram and subset diameters included), and a reduced model run
through the kernels against the same model on the CPU's plain path. Imports no JAX, so it runs
on a machine with a GPU and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Every test skips where CUDA is absent.
"""
import numpy as np
import pytest
import torch

from _torch_parity import CPU, require_cuda
from repro_torch.kernels.cwise_median import ops as median_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.registry import get_bundle
from repro_torch.serve.replica import tree_map

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("S,window", [(128, 0), (1000, 0), (1000, 256)])
def test_flash_kernel_matches_plain(S, window):
    """R*H = 96 rows (4 replicas x 24 heads, 8 kv heads), hd 128, bf16,
    causal. o: one bf16 rounding step of the output plus the plain
    version's bf16 rounding of p (as the JAX oracle's); lse: f32 summation
    order."""
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((4, S, 24, 128), generator=g, device=dev).bfloat16()
    k = torch.randn((4, S, 8, 128), generator=g, device=dev).bfloat16()
    v = torch.randn((4, S, 8, 128), generator=g, device=dev).bfloat16()
    before = flash_ops.flash_attention.launches
    o, lse = flash_ops.flash_attention(q, k, v, causal=True, window=window)
    po, plse = attention_ref(q, k, v, causal=True, window=window,
                             return_lse=True)
    torch.cuda.synchronize()
    assert flash_ops.flash_attention.launches == before + 1
    torch.testing.assert_close(o.float(), po.float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-4)


def test_flash_kernel_f32_ragged_gqa_and_rows_independent():
    """f32, ragged S, Sq < Skv (causal offset); a row's result does not
    depend on how many rows share the launch."""
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((3, 37, 6, 128), generator=g, device=dev)
    k = torch.randn((3, 101, 2, 128), generator=g, device=dev)
    v = torch.randn((3, 101, 2, 128), generator=g, device=dev)
    o, lse = flash_ops.flash_attention(q, k, v, causal=True)
    po, plse = attention_ref(q, k, v, causal=True, return_lse=True)
    torch.testing.assert_close(o, po, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-4)
    o1, _ = flash_ops.flash_attention(q[1:2], k[1:2], v[1:2], causal=True)
    assert torch.equal(o1[0], o[1])
    with pytest.raises(ValueError, match="hd=128"):
        flash_ops.flash_attention(q[..., :64], k[..., :64], v[..., :64])


@pytest.mark.parametrize("n", [1, 3, 4, 5, 64])
def test_median_kernel_matches_plain(n):
    """Exact: the same order statistic and the same f32 average. NaN rows
    included (mapped to _BIG)."""
    dev = require_cuda()
    x = np.random.default_rng(n).standard_normal((n, 4 * 1001))
    x = x.astype(np.float32)
    x[n - n // 2:] = np.nan
    x = torch.from_numpy(x).to(dev)
    before = median_ops.cwise_median.launches
    got = median_ops.cwise_median(x)
    torch.cuda.synchronize()
    assert median_ops.cwise_median.launches == before + 1
    torch.testing.assert_close(got, median_ops.cwise_median_plain(x),
                               rtol=0, atol=0)


def test_reduced_model_on_kernels_matches_cpu_plain_path():
    """Prefill + decode of a reduced model (hd 128, f32 activations) through
    the kernels on the card vs the plain path on the CPU, same params."""
    dev = require_cuda()
    tb = get_bundle("phi4-mini-3.8b", reduced=True, head_dim=128,
                    act_dtype="float32")
    params = tb.init(torch.Generator().manual_seed(0))
    gparams = tree_map(lambda t: t.to(dev), params)
    toks = torch.randint(0, tb.cfg.vocab, (2, 50),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for d, p in ((CPU, params), (dev, gparams)):
        c = tb.init_caches(2, max_len=64, n_chunks=4, device=d)
        lg, c = tb.prefill(p, {"tokens": toks.to(d)}, c)
        logits = [lg]
        for _ in range(3):
            tok = torch.argmax(logits[-1], -1)[:, None]
            lg, c = tb.decode(p, c, {"token": tok})
            logits.append(lg)
        out[d.type] = torch.stack(logits).cpu()
    assert torch.isfinite(out["cuda"]).all()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-3, atol=1e-3)


# -- the training slice's kernels ---------------------------------------------

def _stack(shape, seed, nan_rows=0, integers=False):
    rng = np.random.default_rng(seed)
    x = (rng.integers(-3, 4, size=shape) if integers
         else rng.standard_normal(shape)).astype(np.float32)
    if nan_rows:
        x[..., x.shape[-2] - nan_rows:, ::7] = np.nan   # Byzantine NaN
    return x


@pytest.mark.parametrize("B,n", [(1, 4), (9, 4), (5, 5), (3, 7), (2, 64)])
def test_batched_median_kernel_matches_plain(B, n):
    """Exact, with NaN payloads; row b of a batch equals the unbatched
    launch on stack b."""
    dev = require_cuda()
    x = torch.from_numpy(_stack((B, n, 5003), B + n, nan_rows=1)).to(dev)
    before = median_ops.cwise_median.launches
    got = median_ops.cwise_median(x)
    torch.cuda.synchronize()
    assert median_ops.cwise_median.launches == before + 1
    torch.testing.assert_close(got, median_ops.cwise_median_plain(x),
                               rtol=0, atol=0)
    torch.testing.assert_close(got[-1], median_ops.cwise_median(x[-1]),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n,f", [(3, 1), (5, 1), (7, 2), (8, 3), (64, 20)])
@pytest.mark.parametrize("integers", [False, True])
def test_trimmed_mean_and_meamed_kernels_match_plain(n, f, integers):
    """Exact: the same sorted rows reduced in the same order, the same IEEE
    division; integer stacks make every window tie (MeaMed's tie
    contract)."""
    dev = require_cuda()
    x = torch.from_numpy(_stack((4, n, 3001), 10 * n + f, nan_rows=f,
                                integers=integers)).to(dev)
    for fn, plain in ((median_ops.cwise_trimmed_mean,
                       median_ops.cwise_trimmed_mean_plain),
                      (median_ops.cwise_meamed,
                       median_ops.cwise_meamed_plain)):
        before = fn.launches
        got = fn(x, f)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        torch.testing.assert_close(got, plain(x, f), rtol=0, atol=0)


@pytest.mark.parametrize("B,n,d", [(1, 3, 100), (5, 7, 200_003),
                                   (2, 64, 5000)])
def test_gram_kernel_matches_plain(B, n, d):
    """float32 summation order: Gram entries within 1e-5 of the squared
    norms they are bounded by; d2 likewise; and bit-identical from run to
    run (no atomics)."""
    from repro_torch.kernels.pairwise_sqdist import ops as gram_ops
    dev = require_cuda()
    x = torch.from_numpy(_stack((B, n, d), d)).to(dev)
    before = gram_ops.gram.launches
    g = gram_ops.gram(x)
    torch.cuda.synchronize()
    assert gram_ops.gram.launches == before + 1
    want = gram_ops.gram_plain(x)
    sq = torch.diagonal(want, dim1=-2, dim2=-1)
    scale = (sq[..., :, None] + sq[..., None, :])
    assert torch.all((g - want).abs() <= 1e-5 * scale)
    d2 = gram_ops.pairwise_sqdists(x)
    from repro_torch.kernels.pairwise_sqdist.ref import sqdists_from_gram
    assert torch.all((d2 - sqdists_from_gram(want)).abs() <= 1e-5 * scale)
    assert torch.equal(gram_ops.gram(x), g)


@pytest.mark.parametrize("n,f,B", [(7, 2, 5), (5, 1, 1), (12, 5, 3)])
def test_subset_diameter_kernel_matches_plain(n, f, B):
    """Exact (a max does not depend on its order), NaN included."""
    from repro_torch.agg.rules import subset_masks
    from repro_torch.kernels.mda_diameter import ops as diam_ops
    dev = require_cuda()
    d2 = torch.from_numpy(_stack((B, n, n), n * f) ** 2).to(dev)
    d2[0, 0, 1] = float("nan")
    masks = subset_masks(n, f)
    before = diam_ops.subset_diameters.launches
    got = diam_ops.subset_diameters(d2, masks)
    torch.cuda.synchronize()
    assert diam_ops.subset_diameters.launches == before + 1
    torch.testing.assert_close(
        got, diam_ops.subset_diameters_plain(d2, masks), rtol=0, atol=0,
        equal_nan=True)

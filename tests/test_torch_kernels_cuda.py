"""The CUDA kernels on the card: each against its plain PyTorch version at
shapes of the serving and training paths (the flash backward pair, the
batched median, trimmed mean, MeaMed on both its paths, Gram and the exact
MDA selection included, and the WKV scan's chunk recurrence forward and
backward), gradients through the kernels' ``autograd.Function``, a reduced
model run through the kernels against the same model on the CPU's plain
path, and quorums that repeat a sender (equal rows in the Gram, the
protocol's quorum weights) against the CPU. Imports no JAX, so it runs
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
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     flash_bwd_ref)
from repro_torch.kernels.wkv_scan import ops as wkv_ops
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
    # hd < 128 is zero-padded to the kernel's 128 (scale of the true hd);
    # hd > 128 raises
    o64, lse64 = flash_ops.flash_attention(q[..., :64], k[..., :64],
                                           v[..., :64], causal=True)
    po64, plse64 = attention_ref(q[..., :64], k[..., :64], v[..., :64],
                                 causal=True, return_lse=True)
    torch.testing.assert_close(o64, po64, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(lse64, plse64, rtol=1e-5, atol=1e-4)
    wide = torch.zeros((1, 8, 2, 160), device=dev)
    with pytest.raises(ValueError, match="hd <= 128"):
        flash_ops.flash_attention(wide, wide, wide)


def _bf16_qkv(B, Sq, Skv, H, kvH, seed, hd=128):
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=dev).bfloat16()
                 for shape in ((B, Sq, H, hd), (B, Skv, kvH, hd),
                               (B, Skv, kvH, hd)))


@pytest.mark.parametrize("B,Sq,Skv,H,kvH,causal,window", [
    (4, 1024, 1024, 24, 8, True, 0),      # the protocol run's shape
    (3, 37, 101, 6, 2, True, 0),          # Sq < Skv: the causal offset
    (2, 200, 333, 12, 4, True, 64),       # the offset and a window
    # one row, and 128-row q tiles that are partial or whose second
    # 64-row half is empty or partial
    (2, 1, 1, 8, 2, True, 0), (2, 63, 63, 8, 2, True, 0),
    (2, 65, 65, 8, 2, True, 0), (2, 129, 129, 8, 2, True, 0),
    (2, 1, 300, 8, 2, True, 0), (2, 65, 300, 8, 2, True, 0),
    (2, 200, 333, 8, 2, False, 0), (2, 256, 128, 8, 2, False, 0),
    (4, 1000, 1000, 24, 8, True, 256)])
def test_flash_forward_bf16_tensor_core_kernel(B, Sq, Skv, H, kvH, causal,
                                               window):
    """The bf16 forward (wgmma + TMA ring) against the plain version: o
    within one bf16 step plus the plain version's rounding of p (1e-2),
    lse within f32 summation order (1e-5 rel, 1e-4 abs); two launches
    bit-equal (no atomics)."""
    q, k, v = _bf16_qkv(B, Sq, Skv, H, kvH, Sq + Skv + window)
    o, lse = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    again = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
    po, plse = attention_ref(q, k, v, causal=causal, window=window,
                             return_lse=True)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    torch.testing.assert_close(o.float(), po.float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-4)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


def test_flash_forward_bf16_at_qwen3_moe_heads():
    """qwen3-moe's layout: 64 query heads over 4 kv heads (a GQA group of
    16) of hd 64, padded to 128 by the wrapper, S 1024, causal: against the
    plain version as above, two launches bit-equal."""
    q, k, v = _bf16_qkv(1, 1024, 1024, 64, 4, 64, hd=64)
    o, lse = flash_ops.flash_attention(q, k, v, causal=True)
    again = flash_ops.flash_attention(q, k, v, causal=True)
    po, plse = attention_ref(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    assert o.shape == q.shape
    torch.testing.assert_close(o.float(), po.float(), rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(lse, plse, rtol=1e-5, atol=1e-4)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


@pytest.mark.parametrize("S,window", [(1000, 0), (300, 64)])
def test_flash_forward_bf16_rows_independent(S, window):
    """Serving's token identity: each of R = 4 replicas' rows of a bf16
    launch equals the same replica launched alone (R = 1), bit for bit."""
    q, k, v = _bf16_qkv(4, S, S, 24, 8, S + window)
    o, lse = flash_ops.flash_attention(q, k, v, causal=True, window=window)
    for r in range(4):
        o1, lse1 = flash_ops.flash_attention(q[r:r + 1], k[r:r + 1],
                                             v[r:r + 1], causal=True,
                                             window=window)
        assert torch.equal(o1[0], o[r]) and torch.equal(lse1[0], lse[r])


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


def _gram_within_gate(x):
    """The Gram kernel on ``x`` against its plain version within 1e-5 of
    the squared norms bounding each entry, d2 likewise, and bit-equal
    across two launches; returns the launch plan."""
    from repro_torch.kernels.pairwise_sqdist import ops as gram_ops
    from repro_torch.kernels.pairwise_sqdist.ref import sqdists_from_gram
    before = gram_ops.gram.launches
    g, again = gram_ops.gram(x), gram_ops.gram(x)
    torch.cuda.synchronize()
    assert gram_ops.gram.launches == before + 2
    want = gram_ops.gram_plain(x)
    sq = torch.diagonal(want, dim1=-2, dim2=-1)
    scale = sq[..., :, None] + sq[..., None, :]
    assert torch.all((g - want).abs() <= 1e-5 * scale)
    assert torch.all((sqdists_from_gram(g) - sqdists_from_gram(want)).abs()
                     <= 1e-5 * scale)
    assert torch.equal(g, again)
    n, d = x.shape[-2:]
    return gram_ops.launch_plan(x[..., 0, 0].numel(), n, d, x.data_ptr())


@pytest.mark.parametrize("n", [1, 4, 7, 8, 9, 64])
@pytest.mark.parametrize("r", [0, 1, 2, 3])
def test_gram_kernel_every_n_and_width(n, r):
    """The register kernel (n <= 8) with 16-, 8- and 4-byte loads as d
    mod 4 allows, and the general kernel (n > 8), against the plain
    version."""
    dev = require_cuda()
    d = 3 * 4096 + 128 + r
    plan = _gram_within_gate(torch.from_numpy(_stack((3, n, d), n + r)).to(dev))
    assert plan.path == ("register" if n <= 8 else "general")
    if n <= 8:
        assert plan.vec == {0: 4, 2: 2}.get(r, 1)


@pytest.mark.parametrize("offset,vec", [(1, 1), (2, 2), (3, 1)])
def test_gram_kernel_view_off_a_16_byte_boundary(offset, vec):
    """A contiguous view that starts 4, 8 or 12 bytes past a 16-byte
    boundary takes the load width its start allows."""
    dev = require_cuda()
    n, d = 4, 8192
    buf = torch.from_numpy(_stack((n * d + 4,), offset)).to(dev)
    x = buf[offset:offset + n * d].view(n, d)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4 * offset
    assert _gram_within_gate(x).vec == vec


def test_gram_kernel_at_the_training_shape():
    """MDA at the 5 servers over 7 gradients of mlp_h1024 (D = 1,093,642,
    2 mod 4: 8-byte loads)."""
    dev = require_cuda()
    x = 0.05 * torch.from_numpy(_stack((5, 7, 1_093_642), 7)).to(dev)
    plan = _gram_within_gate(x)
    assert (plan.path, plan.vec) == ("register", 2)


@pytest.mark.parametrize("B,n,d", [(5, 7, 1_093_642), (9, 4, 4099),
                                   (2, 12, 300)])
def test_gram_kernel_equal_rows_give_equal_entries(B, n, d):
    """A quorum that repeats a sender stacks equal rows: the kernel's
    entries of the copies are bit-equal and their distance exactly 0, as in
    the plain version, so MDA's subset diameters tie exactly on the card
    too."""
    from repro_torch.kernels.pairwise_sqdist import ops as gram_ops
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(B + n)
    x = torch.randn((B, n, d), generator=g, device=dev)
    x[:, n - 2], x[:, n - 1] = x[:, 0], x[:, 1]
    got = gram_ops.gram(x)
    assert torch.equal(got, got.mT)
    assert torch.equal(got[:, 0], got[:, n - 2])
    assert torch.equal(got[:, 1], got[:, n - 1])
    d2 = gram_ops.pairwise_sqdists(x)
    assert torch.all(d2[:, 0, n - 2] == 0) and torch.all(d2[:, 1, n - 1] == 0)


def test_quorum_weights_with_a_repeated_sender_equal_the_cpus():
    """The protocol's quorum weights where a sender repeats in a row and
    the selection keeps one copy: the card's weights equal the CPU's (the
    last occurrence wins), over 200 repeats of the same rows, since the
    order of a CUDA scatter to a repeated index is undefined."""
    from repro_torch.core import protocol as tproto
    dev = require_cuda()
    G = 5
    d2 = torch.ones((G, G)) - torch.eye(G)
    idx = torch.tensor([[0, 1, 2, 0], [1, 0, 1, 2], [2, 3, 4, 1],
                        [4, 4, 0, 1], [3, 2, 1, 3]] * 40)
    pcfg = tproto.ProtocolConfig.derive(G, f_workers=1, f_servers=1)
    want = tproto.quorum_weights(d2, idx, 1, pcfg)
    assert want[0, 0] == 0 and want[0, 1] > 0
    for _ in range(200):
        got = tproto.quorum_weights(d2.to(dev), idx.to(dev), 1, pcfg)
        assert torch.equal(got.cpu(), want)


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


def _select_distances(B, n, kind, seed):
    """``[B, n, n]`` squared distances: of random points, of integer points
    on a line (tied diameters), or random with NaN entries."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 4, size=(B, n, 1)) if kind == "ties"
         else rng.standard_normal((B, n, 6))).astype(np.float32)
    d2 = ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)
    if kind == "nan":
        d2[::2, 1, n - 1] = np.nan
        d2[-1, 0, 0] = np.nan
    return torch.from_numpy(d2.astype(np.float32))


@pytest.mark.parametrize("B,n,f", [(1, 7, 2), (5, 7, 2), (300, 5, 2),
                                   (4, 3, 1), (5, 9, 3), (1, 20, 8)])
@pytest.mark.parametrize("kind", ["random", "ties", "nan"])
def test_mda_select_kernel_matches_plain(B, n, f, kind):
    """One launch gives the diameters and the weights of the first minimum
    exactly as the plain version (torch.argmin on the card), ties and NaN
    included; (1, 20, 8) is S = 125,970. The diameters-only wrapper and the
    dispatch's route give the same."""
    from repro_torch.agg import dispatch
    from repro_torch.kernels.mda_diameter import ops as diam_ops
    dev = require_cuda()
    d2 = _select_distances(B, n, kind, B + n + f).to(dev)
    before = diam_ops.subset_diameters.launches
    diam, w = diam_ops.mda_select(d2, f)
    torch.cuda.synchronize()
    assert diam_ops.subset_diameters.launches == before + 1
    want_diam, want_w = diam_ops.mda_select_plain(d2, f)
    torch.testing.assert_close(diam, want_diam, rtol=0, atol=0,
                               equal_nan=True)
    torch.testing.assert_close(w, want_w, rtol=0, atol=0)
    torch.testing.assert_close(
        diam_ops.subset_diameters(d2, diam_ops.subset_masks(n, f)), diam,
        rtol=0, atol=0, equal_nan=True)
    assert torch.equal(dispatch.mda_weights_from_d2(d2, f), w)
    assert torch.equal(dispatch.mda_weights_from_d2(d2[0], f), w[0])


def _meamed_exact(x, f):
    """MeaMed's kernel against its plain version with atol 0; returns the
    launch plan."""
    before = median_ops.cwise_meamed.launches
    got = median_ops.cwise_meamed(x, f)
    torch.cuda.synchronize()
    assert median_ops.cwise_meamed.launches == before + 1
    # NaN where both give NaN (inf - inf in the median or a window sum)
    torch.testing.assert_close(got, median_ops.cwise_meamed_plain(x, f),
                               rtol=0, atol=0, equal_nan=True)
    return median_ops.meamed_plan(x.shape[-2], x.shape[-1], x.data_ptr())


def _with_specials(x, seed):
    """+inf, -inf and values above _BIG (they sort after the pads) in a few
    entries of ``x``."""
    u = np.random.default_rng(seed).random(x.shape)
    x[u < 0.03] = np.inf
    x[(u >= 0.03) & (u < 0.05)] = -np.inf
    x[(u >= 0.05) & (u < 0.07)] = np.float32(3.4028e38)
    return x


@pytest.mark.parametrize("n", range(1, 17))
@pytest.mark.parametrize("d", [3000, 3001])
def test_meamed_exact_kernel_every_n_and_f(n, d):
    """The exact-n kernel for every f < n: two columns a thread with 8-byte
    loads (even d) and the scalar path (odd d), on normal stacks with NaN
    payloads, +-inf and values above _BIG, and on integer stacks."""
    dev = require_cuda()
    for f in range(n):
        for integers in (False, True):
            x = _stack((3, n, d), 100 * n + f, nan_rows=min(f, n - 1),
                       integers=integers)
            if not integers:
                x = _with_specials(x, n + f)
            plan = _meamed_exact(torch.from_numpy(x).to(dev), f)
            assert (plan.path, plan.wires, plan.vec) == ("exact", n,
                                                         2 if d % 2 == 0
                                                         else 1)


@pytest.mark.parametrize("n", [17, 33, 64])
def test_meamed_padded_kernel(n):
    """The padded kernel past 16 rows, with its shifted static-index scan,
    for f from 0 to n - 1."""
    dev = require_cuda()
    for f in sorted({0, 1, n // 3, (n - 1) // 2, n - 1}):
        for integers in (False, True):
            x = _stack((2, n, 2049), n + f, nan_rows=min(f, 3),
                       integers=integers)
            if not integers:
                x = _with_specials(x, n + f)
            plan = _meamed_exact(torch.from_numpy(x).to(dev), f)
            assert (plan.path, plan.vec) == ("padded", 1)


def test_meamed_kernel_view_off_an_8_byte_boundary():
    """A contiguous view that starts 4 bytes past an 8-byte boundary takes
    the scalar path, even with d even."""
    dev = require_cuda()
    n, d = 5, 4096
    buf = torch.from_numpy(_stack((n * d + 1,), 3)).to(dev)
    x = buf[1:].view(n, d)
    assert x.is_contiguous() and x.data_ptr() % 8 == 4
    assert _meamed_exact(x, 1).vec == 1
    assert _meamed_exact(buf[:n * d].view(n, d), 1).vec == 2


def test_meamed_kernel_opposite_side_ties():
    """Windows that tie on the larger endpoint distance from opposite sides
    of the median (equal distances below and above it), broken by the
    in-window distance sum: every 5-row column over {-2, ..., 2}."""
    dev = require_cuda()
    vals = np.arange(-2, 3, dtype=np.float32)
    cols = np.stack(np.meshgrid(*[vals] * 5, indexing="ij"), 0).reshape(5, -1)
    x = torch.from_numpy(np.ascontiguousarray(cols)).to(dev)
    for f in range(5):
        _meamed_exact(x, f)
    x7 = torch.from_numpy(_stack((7, 50_000), 9, integers=True)).to(dev)
    for f in range(7):
        _meamed_exact(x7, f)


# -- the flash backward pair (the zoo training slice) -------------------------

@pytest.mark.parametrize("B,Sq,Skv,H,kvH,hd,window,dtype", [
    (2, 256, 256, 24, 8, 128, 0, torch.bfloat16),
    (2, 200, 333, 12, 4, 128, 64, torch.bfloat16),
    # the protocol run's shape
    (4, 1024, 1024, 24, 8, 128, 0, torch.bfloat16),
    # 5 kv tiles and rep = 3 heads: step counts that are not a multiple of
    # the tensor-core kernels' two-stage ring
    (1, 320, 320, 6, 2, 128, 0, torch.bfloat16),
    (2, 77, 77, 4, 2, 32, 0, torch.float32),
    (3, 65, 65, 8, 8, 64, 9, torch.float32)])
def test_flash_backward_kernels_match_plain(B, Sq, Skv, H, kvH, hd, window,
                                            dtype):
    """dq, dk, dv of the dq and dkv kernels against the plain backward from
    the same o / lse (causal; ragged, windowed, GQA, padded hd). f32:
    summation order; bf16: a few bf16 steps of the grads (the plain version
    rounds once per output too, from f32 sums in another order). Two
    launches are bit-equal (no atomics)."""
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(Sq + hd)
    q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Skv, kvH, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Skv, kvH, hd), generator=g, device=dev).to(dtype)
    do = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dtype)
    o, lse = flash_ops.flash_attention(q, k, v, causal=True, window=window)
    before = (flash_ops.flash_bwd_dq.launches,
              flash_ops.flash_bwd_dkv.launches)
    got = flash_ops.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                        window=window)
    again = flash_ops.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                          window=window)
    want = flash_bwd_ref(q, k, v, o, lse, do, causal=True, window=window)
    torch.cuda.synchronize()
    assert (flash_ops.flash_bwd_dq.launches,
            flash_ops.flash_bwd_dkv.launches) == (before[0] + 2,
                                                  before[1] + 2)
    tol = 3e-4 if dtype == torch.float32 else 3e-2
    for a, b, w in zip(got, again, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), w.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("Sq,Skv", [(200, 333), (256, 128)])
def test_flash_backward_kernels_non_causal(Sq, Skv):
    """bf16 without the causal mask (every key visible, Sq != Skv, ragged):
    the tensor-core dq and dkv kernels against the plain backward, at the
    causal test's tolerance; two launches bit-equal."""
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(Sq + Skv)
    B, H, kvH, hd = 2, 8, 2, 128
    q = torch.randn((B, Sq, H, hd), generator=g, device=dev).bfloat16()
    k = torch.randn((B, Skv, kvH, hd), generator=g, device=dev).bfloat16()
    v = torch.randn((B, Skv, kvH, hd), generator=g, device=dev).bfloat16()
    do = torch.randn((B, Sq, H, hd), generator=g, device=dev).bfloat16()
    o, lse = flash_ops.flash_attention(q, k, v, causal=False)
    got = flash_ops.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    again = flash_ops.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    want = flash_bwd_ref(q, k, v, o, lse, do, causal=False)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), w.float(), rtol=3e-2,
                                   atol=3e-2)


def test_grads_reach_qkv_through_blocked_attention():
    """On the card ``blocked_attention`` is the kernels'
    ``autograd.Function``: q, k and v get the plain version's gradients
    (hd 32, padded)."""
    from repro_torch.models import layers as L
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(5)
    leaves = [torch.randn(s, generator=g, device=dev).requires_grad_()
              for s in ((2, 40, 4, 32), (2, 40, 2, 32), (2, 40, 2, 32))]
    out = L.blocked_attention(*leaves, causal=True)
    assert out.requires_grad
    do = torch.randn(out.shape, generator=g, device=dev)
    grads = torch.autograd.grad(out, leaves, do)
    ref_leaves = [t.detach().clone().requires_grad_() for t in leaves]
    want = torch.autograd.grad(attention_ref(*ref_leaves, causal=True),
                               ref_leaves, do)
    for a, w in zip(grads, want):
        assert a is not None and torch.count_nonzero(a) > 0
        torch.testing.assert_close(a, w, rtol=3e-4, atol=3e-4)


def test_backward_refuses_what_the_kernels_do_not_take():
    """No fallback: a CUDA shape the backward kernels refuse raises."""
    dev = require_cuda()
    q = torch.zeros((1, 8, 2, 160), device=dev)
    lse = torch.zeros((1, 2, 8), device=dev)
    with pytest.raises(ValueError, match="hd <= 128"):
        flash_ops.flash_attention_bwd(q, q, q, q, lse, q)
    q = torch.zeros((1, 8, 2, 64), device=dev)
    with pytest.raises(ValueError, match="hd = 128"):
        flash_ops.flash_bwd_dq(q, q, q, q, lse, lse, scale=0.125)
    q = torch.zeros((1, 9, 2, 128), device=dev)
    k = torch.zeros((1, 8, 2, 128), device=dev)
    with pytest.raises(ValueError, match="Sq <= Skv"):
        flash_ops.flash_attention_bwd(q, k, k, q, torch.zeros(
            (1, 2, 9), device=dev), q)


# ---------------------------------------------------------------------------
# the WKV scan's chunk recurrence
# ---------------------------------------------------------------------------

EPS = 2.0 ** -23        # float32's spacing at 1: two roundings' worth


def _scan_case(N, B, H, K, V, seed):
    """Decays in (0, 1], ``add``, ``s0`` and the two incoming gradients."""
    dev = require_cuda()
    g = torch.Generator(device=dev).manual_seed(seed)
    decay = 1.0 - torch.rand((N, B, H, K), generator=g, device=dev)
    add, d_ent = (torch.randn((N, B, H, K, V), generator=g, device=dev)
                  for _ in range(2))
    s0, d_fin = (torch.randn((B, H, K, V), generator=g, device=dev)
                 for _ in range(2))
    return decay, add, s0, d_ent, d_fin


def _chain_close(got, want, steps, scale):
    """Within ``steps`` roundings of a chain that carries values up to
    ``scale``: the kernels round each multiply-add once (fmaf), the plain
    version twice, and the decays (<= 1) carry an error on undiminished."""
    torch.testing.assert_close(got, want, rtol=0,
                               atol=steps * EPS * float(scale))


@pytest.mark.parametrize("N,B,H,K,V", [(256, 4, 40, 64, 64), (37, 2, 3, 8, 8),
                                       (3, 1, 5, 7, 8), (9, 3, 1, 3, 4),
                                       (10, 1, 2, 2, 128)])
def test_wkv_state_scan_kernels_match_plain(N, B, H, K, V):
    """The forward's entering states and final state, and the backward's
    d_decay, d_add and d_s0 (from the kernel's own entering states),
    against the plain loops on the card: at the training shape, at the
    tests' V = 8, N under and past the kernels' ring of 8 chunks, rows
    that leave a warp partly empty, every lane count."""
    decay, add, s0, d_ent, d_fin = _scan_case(N, B, H, K, V, N + V)
    before = wkv_ops.scan_fwd.launches, wkv_ops.scan_bwd.launches
    ent, fin = wkv_ops.scan_fwd(decay, add, s0)
    d_decay, d_add, d_s0 = wkv_ops.scan_bwd(decay, ent, d_ent, d_fin)
    torch.cuda.synchronize()
    assert (wkv_ops.scan_fwd.launches, wkv_ops.scan_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    p_ent, p_fin = wkv_ops.scan_fwd_plain(decay, add, s0)
    p_dd, p_da, p_ds0 = wkv_ops.scan_bwd_plain(decay, ent, d_ent, d_fin, True)
    s_max = max(p_ent.abs().max(), p_fin.abs().max())
    g_max = max(p_da.abs().max(), p_ds0.abs().max())
    _chain_close(ent, p_ent, N, s_max)
    _chain_close(fin, p_fin, N, s_max)
    _chain_close(d_add, p_da, N, g_max)
    _chain_close(d_s0, p_ds0, N, g_max)
    # V products summed in another order, on a gradient N roundings off
    _chain_close(d_decay, p_dd, N + V, V * g_max * ent.abs().max())


def test_wkv_state_scan_kernel_without_d_final_or_d_s0():
    decay, add, s0, d_ent, _ = _scan_case(20, 2, 3, 8, 64, 1)
    ent, _ = wkv_ops.scan_fwd(decay, add, s0)
    d_decay, d_add, d_s0 = wkv_ops.scan_bwd(decay, ent, d_ent, None,
                                            d_s0=False)
    p_dd, p_da, _ = wkv_ops.scan_bwd_plain(decay, ent, d_ent, None, False)
    assert d_s0 is None
    g_max = p_da.abs().max()
    _chain_close(d_add, p_da, 20, g_max)
    _chain_close(d_decay, p_dd, 20 + 64, 64 * g_max * ent.abs().max())


def test_wkv_state_scan_kernels_repeat_bit_for_bit():
    decay, add, s0, d_ent, d_fin = _scan_case(64, 4, 40, 64, 64, 2)
    runs = []
    for _ in range(2):
        ent, fin = wkv_ops.scan_fwd(decay, add, s0)
        runs.append((ent, fin, *wkv_ops.scan_bwd(decay, ent, d_ent, d_fin)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_wkv_state_scan_refuses_what_the_kernels_do_not_take():
    """No fallback: a CUDA operand the kernels do not take raises."""
    decay, add, s0, _, _ = _scan_case(3, 1, 2, 4, 8, 0)
    dev = add.device
    flat = torch.zeros(add.numel() + 1, device=dev)
    bad = {
        "float32": (decay.double(), add.double(), s0.double()),
        "V in": (decay, torch.zeros((3, 1, 2, 4, 12), device=dev),
                 torch.zeros((1, 2, 4, 12), device=dev)),
        "contiguous": (decay, torch.zeros((3, 1, 2, 8, 4), device=dev)
                       .transpose(-1, -2), s0),
        "aligned": (decay, flat[1:].view(add.shape), s0),
        "unsupported device": (decay.cpu(), add, s0),
        "state_scan takes": (decay, add, s0[0]),
    }
    for match, args in bad.items():
        with pytest.raises(ValueError, match=match):
            wkv_ops.state_scan(*args)


def test_wkv_chunked_on_the_card_one_launch_each_way_and_cpu_grads():
    """``wkv_chunked`` at rwkv6-3b's heads over S = 300 (19 chunks, the
    last padded) from a non-zero state, with gradients: one forward and
    one backward launch of the recurrence, each inside a
    ``rwkv6.wkv_state`` span, and the gradients of r, k, v, lw, u and s0
    against the CPU's (float32 products summed in other orders)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import rwkv6
    dev = require_cuda()
    rng = np.random.default_rng(4)
    B, S, H, K = 2, 300, 40, 64

    def a(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape))
                                .astype(np.float32))
    args = (a(B, S, H, K), a(B, S, H, K), a(B, S, H, K),
            -torch.exp(a(B, S, H, K, scale=0.5)), a(H, K, scale=0.1),
            a(B, H, K, K, scale=0.3))
    cot_y, cot_s = a(B, S, H, K), a(B, H, K, K)

    def grads(device):
        leaves = [t.to(device).requires_grad_() for t in args]
        y, fin = rwkv6.wkv_chunked(*leaves)
        return torch.autograd.grad((y * cot_y.to(device)).sum()
                                   + (fin * cot_s.to(device)).sum(), leaves)
    want = grads(CPU)
    before = wkv_ops.scan_fwd.launches, wkv_ops.scan_bwd.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = grads(dev)
        torch.cuda.synchronize()
    assert (wkv_ops.scan_fwd.launches, wkv_ops.scan_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    cpu = torch.autograd.DeviceType.CPU
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    spans = [e for e in prof.profiler.kineto_results.events()
             if e.name() == wkv_ops.SPAN and e.device_type() == cpu]
    assert len(spans) == 2          # the host's ranges (not their GPU copies)
    assert sum("state_scan_fwd_kernel" in n for n in names) == 1
    assert sum("state_scan_bwd_kernel" in n for n in names) == 1
    for name, g, w in zip(("r", "k", "v", "lw", "u", "s0"), got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()),
                                   msg=name)

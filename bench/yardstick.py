"""The yardstick: the card's peaks and the work of each hand-written
kernel's call, counted from its shapes.

The work formulas are a frozen copy of the port's own counts
(``repro_torch/kernels/*/ops.py``, reported through
``repro_torch/kernels/work.py``), but for attention's backward, counted
as the function's own work rather than its two kernels' (which redo
products): each multiply-add is two operations, a compare-exchange two,
and the bytes count each input read once and each output written once.
A roofline share is the least time the card could take for a call, the
larger of its operations over the peak rate and its bytes over the
memory's bandwidth, over the time the call took.
"""
from __future__ import annotations

import math

#: NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_BF16 = 989e12        # FLOP/s on the tensor cores, bf16 and fp16
PEAK_F32 = 67e12          # FLOP/s in float32 outside the tensor cores
HBM_BPS = 3.35e12         # bytes/s


def bound_s(ops: float, nbytes: float, peak: float) -> float:
    """The least seconds a call of ``ops`` operations moving ``nbytes``
    bytes can take on a card of ``peak`` operations a second."""
    return max(ops / peak, nbytes / HBM_BPS)


# -- flash attention (kernels/flash_attention: forward, backward) ---------

def visible_pairs(Sq: int, Skv: int, window: int = 0,
                  causal: bool = True) -> int:
    """(q, k) pairs of one (batch, head) that the mask leaves visible."""
    if not causal:
        return Sq * Skv
    lo, hi = Skv - Sq + 1, Skv
    if not window or window >= hi:
        return (lo + hi) * Sq // 2
    if window <= lo:
        return window * Sq
    return (lo + window) * (window - lo + 1) // 2 + window * (hi - window)


def flash_fwd_work(B, Sq, Skv, H, kvH, hd, itemsize, causal=True, window=0):
    """QK^T and PV on the visible pairs; q, k, v read, o written, the
    float32 log-sum-exp written."""
    ops = 4.0 * hd * visible_pairs(Sq, Skv, window, causal) * B * H
    nbytes = itemsize * (2 * B * Sq * H * hd + 2 * B * Skv * kvH * hd) \
        + 4.0 * B * H * Sq
    return ops, nbytes


def flash_bwd_work(B, Sq, Skv, H, kvH, hd, itemsize, causal=True, window=0):
    """The attention backward's own work, however its kernels split it:
    QK^T again (the probabilities are not kept), dO V^T, P^T dO, dS K and
    dS^T Q on the visible pairs; q, o, do, k, v and the log-sum-exp read,
    dq, dk and dv written once."""
    pairs = visible_pairs(Sq, Skv, window, causal) * B * H
    qb, kvb = itemsize * B * Sq * H * hd, itemsize * B * Skv * kvH * hd
    return 2.0 * hd * pairs * 5, 4 * qb + 4 * kvb + 4.0 * B * H * Sq


# -- the aggregation kernels (cwise_median, pairwise_sqdist, mda_diameter) -

def bitonic_ops(n: int) -> int:
    """min/max operations per column of the bitonic network over n rows
    padded to a power of two."""
    lg = max(n - 1, 0).bit_length()
    return (1 << lg) * lg * (lg + 1) // 2


def median_work(B: int, n: int, d: int):
    """The median over ``[B, n, d]`` float32: the network on each column;
    the stack read, ``[B, d]`` written."""
    return float(bitonic_ops(n) * B * d), 4.0 * (B * n * d + B * d)


def gram_work(B: int, n: int, d: int):
    """The Gram of ``[B, n, d]`` float32: the n (n + 1) / 2 row pairs'
    products over d; the stack read, ``[B, n, n]`` written."""
    return 2.0 * B * (n * (n + 1) // 2) * d, 4.0 * (B * n * d + B * n * n)


def select_work(B: int, n: int, S: int, k: int, weights: bool = True):
    """MDA's selection over ``[B, n, n]`` distances and S subsets of k
    members: a max over each subset's k x k pairs; the distances and the
    int64 bitmasks read, the diameters (and weights) written."""
    return (float(B * S * k * k),
            4.0 * (B * n * n + B * S + (B * n if weights else 0)) + 8.0 * S)


def n_subsets(n: int, f: int) -> int:
    return math.comb(n, n - f)

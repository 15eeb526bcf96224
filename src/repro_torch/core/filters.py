"""Model-legitimacy filters of the synchronous ByzSGD variant (paper §5),
the port of ``repro.core.filters``.

Workers pull ONE model per step (round-robin over servers) and validate it:

* **Lipschitz filter** — the empirical Lipschitz coefficient
  k = ||g_{t+1} - g_t|| / ||theta_local - theta_prev|| must lie within the
  (n_ps - f_ps)/n_ps quantile of the worker's history of coefficients.
* **Outliers filter** — the pulled model must lie within the Eq. (14) ball
  of the locally speculated model theta_local = theta_prev - eta * g_t.

Models and gradients are flat ``[.., D]`` tensors; the history is one
NaN-filled ring buffer per worker, ``[n_w, H]``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class LipschitzHistory(NamedTuple):
    """Ring buffers of past Lipschitz coefficients: ``buf [.., H]`` float32
    (NaN = empty) and the write cursors ``idx [..]`` int."""
    buf: torch.Tensor
    idx: torch.Tensor

    @staticmethod
    def create(n: int, horizon: int = 128, device=None) -> "LipschitzHistory":
        return LipschitzHistory(
            torch.full((n, horizon), torch.nan, dtype=torch.float32,
                       device=device),
            torch.zeros((n,), dtype=torch.int64, device=device))

    def push(self, k: torch.Tensor) -> "LipschitzHistory":
        """Write ``k [..]`` at each buffer's cursor."""
        h = self.buf.shape[-1]
        buf = self.buf.scatter(-1, (self.idx % h)[..., None], k[..., None])
        return LipschitzHistory(buf, self.idx + 1)


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum((a - b).float() ** 2, dim=-1))


def lipschitz_coefficient(new_grad, old_grad, local_model, old_model):
    """k = ||g_{t+1}-g_t|| / ||theta_{t+1} - theta_t|| over ``[.., D]``."""
    return _dist(new_grad, old_grad) / torch.clamp(
        _dist(local_model, old_model), min=1e-20)


def lipschitz_cutoff(hist: LipschitzHistory, n_ps: int, f_ps: int):
    """The (n_ps-f_ps)/n_ps empirical quantile of each history (NaN while a
    history is empty = accept everything); linear interpolation, as
    ``jnp.nanpercentile``."""
    return torch.nanquantile(hist.buf, (n_ps - f_ps) / n_ps, dim=-1,
                             interpolation="linear")


def lipschitz_pass(k, hist: LipschitzHistory, n_ps: int, f_ps: int):
    """``k <= quantile_{(n_ps-f_ps)/n_ps}{K}``; accepts while a history is
    empty."""
    kp = lipschitz_cutoff(hist, n_ps, f_ps)
    return torch.isnan(kp) | (k <= kp)


def outliers_bound(t: int, big_t: int, eta_anchor, gnorm_anchor, n_w: int,
                   f_w: int):
    """Eq. (14): eta_{T(t mod T)} ||g_{T(t mod T)}|| *
    ((3T+2)(n_w-f_w) / 4f_w + 2((t-1) mod T))."""
    fw = max(f_w, 1)
    growth = ((3.0 * big_t + 2.0) * (n_w - f_w) / (4.0 * fw)
              + 2.0 * ((t - 1) % big_t))
    return eta_anchor * gnorm_anchor * growth


def outliers_pass(pulled_model, local_model, bound):
    return _dist(pulled_model, local_model) < bound


def safe_T(lipschitz_l: float, eta1: float) -> int:
    """Paper Eq. (13): T <= 1 / (3 * l * eta_1) — the max scatter length."""
    return max(int(1.0 / (3.0 * lipschitz_l * eta1)), 1)

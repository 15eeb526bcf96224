"""Plain PyTorch pieces of the Gram kernel: the step from a Gram matrix to
squared distances (the wrapper's, as ``ops.py:39`` in the JAX package), and
the one-product Gram that the dispatch runs past the kernel's n <= 64."""
from __future__ import annotations

import torch


def sqdists_from_gram(g: torch.Tensor) -> torch.Tensor:
    """``[.., n, n]`` Gram -> squared distances
    ``max(diag + diag^T - 2G, 0)`` (NaN propagates, as ``jnp.maximum``)."""
    sq = torch.diagonal(g, dim1=-2, dim2=-1)
    d2 = (sq[..., :, None] + sq[..., None, :]) - 2.0 * g
    return torch.maximum(d2, torch.zeros_like(d2))


def gram_ref(x: torch.Tensor) -> torch.Tensor:
    """``x @ x^T`` in float32 over the last two dims."""
    x = x.float()
    return x @ x.mT

"""Convert the JAX package's transformer params into the port's.

Both packages use one tree (``embed/table``, ``blocks/<...>`` stacked
``[L, ...]``, ``ln_f/scale``) and one weight layout (``[in, out]``, applied
as ``x @ w``), so the conversion is leaf by leaf with no transpose. The
input is the JAX tree already moved to the host as numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``), so this module needs no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ArchConfig


def _leaf(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes bf16: reinterpret bits
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree_of_numpy, cfg: ArchConfig, device="cuda",
                    dtype: torch.dtype | None = None):
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``
    (cast to ``dtype`` when given). Checks the tree against ``cfg``."""
    blocks = tree_of_numpy["blocks"]
    L = cfg.n_layers
    want = {("attn", "wq"): (L, cfg.d_model, cfg.n_heads * cfg.hd),
            ("attn", "wk"): (L, cfg.d_model, cfg.n_kv_heads * cfg.hd),
            ("mlp", "w_down"): (L, cfg.d_ff, cfg.d_model)}
    for (a, b), shape in want.items():
        got = tuple(np.shape(blocks[a][b]))
        if got != shape:
            raise ValueError(f"blocks/{a}/{b} is {got}; cfg {cfg.name} "
                             f"expects {shape}")

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return _leaf(t, device, dtype)

    return walk(tree_of_numpy)

"""Carry state from the JAX package into the port: transformer params, MLP
params, and a whole ByzSGD simulator state.

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
        t = torch.from_numpy(np.array(
            a, copy=True if not a.flags.writeable else None, order="C"))
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


def mlp_params_from_jax(tree_of_numpy, device="cuda") -> dict:
    """A JAX MLP param dict (``{w0, b0, ...}`` of numpy arrays, ``[in,
    out]`` weights) -> the same dict of float32 tensors on ``device``."""
    return {k: _leaf(v, device, torch.float32)
            for k, v in tree_of_numpy.items()}


def sim_state_from_jax(jstate, cfg, device="cuda", seed: int = 0):
    """The numpy leaves of a JAX ``SimState`` (e.g.
    ``jax.tree.map(np.asarray, state)``) -> the port's ``SimState`` for
    ``cfg``: params, worker models and gradients flattened in JAX leaf order
    into ``[n, D]`` stacks, the host step counter, and a generator seeded
    with ``seed`` in place of the JAX key (the two never draw alike)."""
    from ..core.filters import LipschitzHistory
    from ..core.simulator import FlatTree, SimState

    tree = FlatTree.from_params(jstate.params, lead=1)

    def tensors(t):
        if isinstance(t, dict):
            return {k: tensors(v) for k, v in t.items()}
        return _leaf(t, device, torch.float32)

    def flat(params):
        return tree.flatten(tensors(params), lead=1)

    def scalar(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    params = flat(jstate.params)
    if params.shape[0] != cfg.n_servers:
        raise ValueError(f"state has {params.shape[0]} servers; cfg "
                         f"{cfg.n_servers}")
    return SimState(
        params=params, t=int(np.asarray(jstate.t)),
        gen=torch.Generator(device=device).manual_seed(seed),
        w_model=flat(jstate.w_model), w_grad=flat(jstate.w_grad),
        w_r=scalar(jstate.w_r, torch.int64),
        lip=LipschitzHistory(scalar(jstate.lip.buf),
                             scalar(jstate.lip.idx, torch.int64)),
        anchor_eta=scalar(jstate.anchor_eta),
        anchor_gnorm=scalar(jstate.anchor_gnorm))

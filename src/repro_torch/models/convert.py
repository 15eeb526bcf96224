"""Carry state from the JAX package into the port: zoo model params (every
family), MLP params, and a whole ByzSGD simulator state.

Both packages use one tree per family (``embed/table``, ``blocks/<...>``
stacked ``[L, ...]`` and ``ln_f``; the hybrid's ``mamba/<...>`` and
``shared/<...>``; the encoder-decoder's ``enc_blocks``, ``dec_blocks``,
``pos_dec``, ``ln_enc``) and one weight layout (``[in, out]``, applied
as ``x @ w``), so the conversion is leaf by leaf with no transpose. The
input is the JAX tree already moved to the host as numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``), so this module needs no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ArchConfig
from .encdec import MAX_DEC_POSITIONS


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
    (cast to ``dtype`` when given, else each leaf keeps its own). Checks
    the tree against ``cfg``: a few leaves that fix the family's widths,
    named by their path from the root."""
    for path, shape in _checked_leaves(cfg).items():
        node = tree_of_numpy
        for k in path:
            if not isinstance(node, dict) or k not in node:
                raise ValueError(f"{'/'.join(path)} is missing; cfg "
                                 f"{cfg.name} ({cfg.family}) expects "
                                 f"{shape}")
            node = node[k]
        if tuple(np.shape(node)) != shape:
            raise ValueError(f"{'/'.join(path)} is "
                             f"{tuple(np.shape(node))}; cfg {cfg.name} "
                             f"expects {shape}")

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return _leaf(t, device, dtype)

    return walk(tree_of_numpy)


def _checked_leaves(cfg: ArchConfig) -> dict:
    """Leaf path from the root -> the shape ``cfg`` gives it, per family."""
    L, D = cfg.n_layers, cfg.d_model
    if cfg.family == "ssm":
        K = cfg.ssm_head_dim
        return {("blocks", "Wr"): (L, D, D),
                ("blocks", "cWv"): (L, cfg.d_ff, D),
                ("blocks", "u"): (L, D // K, K)}
    if cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * D
        N, H = cfg.ssm_state, d_inner // cfg.ssm_head_dim
        heads = cfg.shared_attn_heads or cfg.n_heads
        return {("mamba", "in_proj"): (L, D, 2 * d_inner + 2 * N + H),
                ("mamba", "out_proj"): (L, d_inner, D),
                ("shared", "attn", "wq"): (D, heads * (D // heads)),
                ("shared", "mlp", "w_down"):
                    (cfg.shared_attn_d_ff or cfg.d_ff, D),
                ("embed", "table"): (cfg.vocab, D), ("ln_f", "scale"): (D,)}
    if cfg.family == "audio":
        Le, HD = cfg.encoder_layers, cfg.n_heads * cfg.hd
        return {("enc_blocks", "attn", "wq"): (Le, D, HD),
                ("enc_blocks", "mlp", "w_up"): (Le, D, cfg.d_ff),
                ("dec_blocks", "cross_attn", "wk"): (L, D, HD),
                ("dec_blocks", "mlp", "w_down"): (L, cfg.d_ff, D),
                ("pos_dec",): (MAX_DEC_POSITIONS, D),
                ("ln_enc", "bias"): (D,),
                ("ln_f", "bias"): (D,)}
    attn = {("blocks", "attn", "wq"): (L, D, cfg.n_heads * cfg.hd),
            ("blocks", "attn", "wk"): (L, D, cfg.n_kv_heads * cfg.hd),
            ("blocks", "ln_attn", "scale"): (L, D), ("ln_f", "scale"): (D,)}
    if cfg.norm == "layernorm":
        attn[("blocks", "ln_attn", "bias")] = (L, D)
        attn[("ln_f", "bias")] = (D,)
    if cfg.family == "moe":
        E = cfg.n_experts
        return {**attn, ("blocks", "moe", "router"): (L, D, E),
                ("blocks", "moe", "w_down"): (L, E, cfg.d_ff, D)}
    return {**attn, ("blocks", "mlp", "w_down"): (L, cfg.d_ff, D)}


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


def protocol_state_from_jax(jstate, device="cuda", seed: int = 0):
    """The numpy leaves of a JAX protocol ``ByzState`` (e.g.
    ``jax.tree.map(np.asarray, state)``) -> the port's ``ByzState``: the
    replica-stacked params flattened in JAX leaf order into one ``[G, P]``
    stack in their own dtype (with the
    :class:`~repro_torch.core.simulator.FlatTree` that
    records the layout), the step counter on the host, a generator seeded
    with ``seed`` in place of the JAX key (the two never draw alike), and
    the optimizer state — ``()`` for sgd, AdamW's moments flattened like the
    params."""
    from ..core.protocol import ByzState
    from ..core.simulator import FlatTree
    from ..optim.adamw import AdamWState

    tree = FlatTree.from_params(jstate.params, lead=1)

    def flat(t):
        # the leaves' own dtype (bf16 replicas stay bf16), not the
        # simulator's float32 of ``FlatTree.flatten``
        def tensors(x):
            if isinstance(x, dict):
                return {k: tensors(v) for k, v in x.items()}
            return _leaf(x, device, None)
        return torch.cat([leaf.reshape(leaf.shape[0], -1)
                          for leaf in tree.leaves(tensors(t))], dim=-1)

    opt = jstate.opt
    if opt is not None and len(opt) == 3 and isinstance(opt[0], dict):
        opt = AdamWState(flat(opt[0]), flat(opt[1]), int(np.asarray(opt[2])))
    else:
        opt = ()
    return ByzState(params=flat(jstate.params), t=int(np.asarray(jstate.t)),
                    gen=torch.Generator(device=device).manual_seed(seed),
                    opt=opt, tree=tree)

"""Shared helpers of the ``test_torch_*`` parity tests: numpy-drawn inputs
handed to both packages (JAX on the CPU as the oracle, the PyTorch port with
``device="cpu"``), and the card check for the tests that need one.

Under pytest-xdist every worker imports this module at collection and then
runs torch with the cores' share of one worker: torch's default, an
intra-op thread per core in each worker, oversubscribes the cores, and its
waiting threads then slow a CPU run by tens of times (``lm/moe_tiny``'s
preset: 13 s on one thread beside 7 busy processes on 8 cores, over 150 s
on 8 threads)."""
import os

import numpy as np
import pytest
import torch

CPU = torch.device("cpu")

if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))


def np_dtype_cast(a: np.ndarray, dtype: str):
    """(jax array, torch tensor) of the same values in ``dtype``
    ("float32" | "bfloat16"), rounded once, in JAX."""
    import jax.numpy as jnp
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def numpy_params(cfg, seed: int = 0) -> dict:
    """A param tree of ``cfg``'s family in the JAX layout, drawn with
    numpy: truncated-normal-like weights over sqrt(fan_in), non-unit norm
    scales (and non-zero layernorm and MLP biases); for RWKV6 a non-zero
    decay LoRA ``wB`` (zero at init, where it would hide ``wA`` from every
    gradient); for Mamba2 non-zero ``A_log``, ``conv_b`` and spread
    ``dt_bias`` (constants at init)."""
    rng = np.random.default_rng(seed)
    L, D, hd = cfg.n_layers, cfg.d_model, cfg.hd
    H, kvH, Fd = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def dense(fan_in, *shape):
        w = np.clip(rng.standard_normal(shape), -2, 2) / np.sqrt(fan_in)
        return w.astype(np.float32)

    def normal(scale, *shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def scale(*shape):
        return (1.0 + normal(0.1, *shape)).astype(np.float32)

    embed = {"table": normal(0.02, cfg.vocab, D)}

    def ln(*lead):
        return {"scale": scale(*lead, D), "bias": normal(0.1, *lead, D)}

    def attn(lead, heads, kv_heads, head_dim):
        return {"wq": dense(D, *lead, D, heads * head_dim),
                "wk": dense(D, *lead, D, kv_heads * head_dim),
                "wv": dense(D, *lead, D, kv_heads * head_dim),
                "wo": dense(heads * head_dim, *lead, heads * head_dim, D)}

    if cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * D
        N, P = cfg.ssm_state, cfg.ssm_head_dim
        Hs, C = d_inner // P, d_inner + 2 * cfg.ssm_state
        heads = cfg.shared_attn_heads or H
        sFd = cfg.shared_attn_d_ff or Fd
        mamba = {"ln": {"scale": scale(L, D)},
                 "in_proj": dense(D, L, D, 2 * d_inner + 2 * N + Hs),
                 "conv_w": normal(0.1, L, cfg.ssm_conv, C),
                 "conv_b": normal(0.1, L, C),
                 "A_log": normal(0.5, L, Hs),
                 "dt_bias": (-2.0 + normal(0.5, L, Hs)).astype(np.float32),
                 "D_skip": scale(L, Hs),
                 "gate_ln": {"scale": scale(L, d_inner)},
                 "out_proj": dense(d_inner, L, d_inner, D)}
        shared = {"ln_attn": {"scale": scale(D)},
                  "attn": attn((), heads, heads, D // heads),
                  "ln_mlp": {"scale": scale(D)},
                  "mlp": {"w_gate": dense(D, D, sFd), "w_up": dense(D, D, sFd),
                          "w_down": dense(sFd, sFd, D)}}
        return {"embed": embed, "mamba": mamba, "shared": shared,
                "ln_f": {"scale": scale(D)}}
    if cfg.family == "audio":
        def gelu_mlp(n):
            return {"w_up": dense(D, n, D, Fd), "b_up": normal(0.1, n, Fd),
                    "w_down": dense(Fd, n, Fd, D), "b_down": normal(0.1, n, D)}
        Le = cfg.encoder_layers
        return {"embed": embed, "pos_dec": normal(0.01, 65536, D),
                "enc_blocks": {"ln_attn": ln(Le),
                               "attn": attn((Le,), H, H, hd),
                               "ln_mlp": ln(Le), "mlp": gelu_mlp(Le)},
                "dec_blocks": {"ln_self": ln(L),
                               "self_attn": attn((L,), H, H, hd),
                               "ln_cross": ln(L),
                               "cross_attn": attn((L,), H, H, hd),
                               "ln_mlp": ln(L), "mlp": gelu_mlp(L)},
                "ln_enc": ln(), "ln_f": ln()}
    if cfg.family == "ssm":
        K = cfg.ssm_head_dim

        def mu():
            return rng.uniform(size=(L, D)).astype(np.float32)

        blocks = {"ln1": ln(L), "ln2": ln(L), "mu_r": mu(), "mu_k": mu(),
                  "mu_v": mu(), "mu_w": mu(), "mu_g": mu(),
                  "Wr": dense(D, L, D, D), "Wk": dense(D, L, D, D),
                  "Wv": dense(D, L, D, D), "Wg": dense(D, L, D, D),
                  "w0": scale(L, D), "wA": dense(D, L, D, 64),
                  "wB": normal(0.3, L, 64, D), "u": normal(0.1, L, D // K, K),
                  "ln_x": ln(L), "Wo": dense(D, L, D, D), "mu_ck": mu(),
                  "mu_cr": mu(), "cWk": dense(D, L, D, Fd),
                  "cWv": dense(Fd, L, Fd, D), "cWr": dense(D, L, D, D)}
        return {"embed": embed, "blocks": blocks,
                "ln_f": {"scale": scale(D), "bias": normal(0.1, D)}}
    def norm(*lead):
        return ln(*lead) if cfg.norm == "layernorm" else {
            "scale": scale(*lead, D)}

    blocks = {
        "ln_attn": norm(L),
        "attn": attn((L,), H, kvH, hd),
        "ln_mlp": norm(L),
    }
    if cfg.family == "moe":
        E = cfg.n_experts
        blocks["moe"] = {"router": dense(D, L, D, E),
                         "w_gate": normal(0.02, L, E, D, Fd),
                         "w_up": normal(0.02, L, E, D, Fd),
                         "w_down": normal(0.02, L, E, Fd, D)}
    else:
        blocks["mlp"] = {"w_gate": dense(D, L, D, Fd),
                         "w_up": dense(D, L, D, Fd),
                         "w_down": dense(Fd, L, Fd, D)}
    params = {"embed": embed, "blocks": blocks, "ln_f": norm()}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": dense(D, cfg.vocab, D)}
    return params


def jax_tree(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, tree)


class _Elsewhere(torch.Tensor):
    """A tensor that claims a device the port has no route for (neither
    the CPU, a GPU nor ``meta``) and holds nothing: any operation on it
    raises."""

    @staticmethod
    def __new__(cls, shape, dtype=torch.float32):
        return torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=dtype, device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} reached a tensor of no device")


def elsewhere(shape, dtype=torch.float32) -> torch.Tensor:
    """A tensor on a device the kernel wrappers do not take (the tests of
    their refusal: only the CPU, a GPU and ``meta`` have a route)."""
    return _Elsewhere(tuple(shape), dtype)


def require_cuda() -> torch.device:
    """Skip the calling test unless an NVIDIA GPU is present (decided when
    the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); run on the card")
    return torch.device("cuda")

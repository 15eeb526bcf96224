"""Shared helpers of the ``test_torch_*`` parity tests: numpy-drawn inputs
handed to both packages (JAX on the CPU as the oracle, the PyTorch port with
``device="cpu"``), and the card check for the tests that need one."""
import numpy as np
import pytest
import torch

CPU = torch.device("cpu")


def np_dtype_cast(a: np.ndarray, dtype: str):
    """(jax array, torch tensor) of the same values in ``dtype``
    ("float32" | "bfloat16"), rounded once, in JAX."""
    import jax.numpy as jnp
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def numpy_params(cfg, seed: int = 0) -> dict:
    """A param tree of ``cfg``'s family (dense, moe or ssm) in the JAX
    layout, drawn with numpy: truncated-normal-like weights over
    sqrt(fan_in), non-unit norm scales (and non-zero layernorm biases),
    and, for RWKV6, a non-zero decay LoRA ``wB`` (zero at init, where it
    would hide ``wA`` from every gradient)."""
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
    if cfg.family == "ssm":
        K = cfg.ssm_head_dim

        def ln():
            return {"scale": scale(L, D), "bias": normal(0.1, L, D)}

        def mu():
            return rng.uniform(size=(L, D)).astype(np.float32)

        blocks = {"ln1": ln(), "ln2": ln(), "mu_r": mu(), "mu_k": mu(),
                  "mu_v": mu(), "mu_w": mu(), "mu_g": mu(),
                  "Wr": dense(D, L, D, D), "Wk": dense(D, L, D, D),
                  "Wv": dense(D, L, D, D), "Wg": dense(D, L, D, D),
                  "w0": scale(L, D), "wA": dense(D, L, D, 64),
                  "wB": normal(0.3, L, 64, D), "u": normal(0.1, L, D // K, K),
                  "ln_x": ln(), "Wo": dense(D, L, D, D), "mu_ck": mu(),
                  "mu_cr": mu(), "cWk": dense(D, L, D, Fd),
                  "cWv": dense(Fd, L, Fd, D), "cWr": dense(D, L, D, D)}
        return {"embed": embed, "blocks": blocks,
                "ln_f": {"scale": scale(D), "bias": normal(0.1, D)}}
    blocks = {
        "ln_attn": {"scale": scale(L, D)},
        "attn": {"wq": dense(D, L, D, H * hd),
                 "wk": dense(D, L, D, kvH * hd),
                 "wv": dense(D, L, D, kvH * hd),
                 "wo": dense(H * hd, L, H * hd, D)},
        "ln_mlp": {"scale": scale(L, D)},
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
    params = {"embed": embed, "blocks": blocks, "ln_f": {"scale": scale(D)}}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": dense(D, cfg.vocab, D)}
    return params


def jax_tree(tree):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(jnp.asarray, tree)


def require_cuda() -> torch.device:
    """Skip the calling test unless an NVIDIA GPU is present (decided when
    the test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); run on the card")
    return torch.device("cuda")

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
    """A dense-transformer param tree in the JAX layout, drawn with numpy
    (truncated-normal-like weights over sqrt(fan_in), non-unit norm scales)."""
    rng = np.random.default_rng(seed)
    L, D, hd = cfg.n_layers, cfg.d_model, cfg.hd
    H, kvH, Fd = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff

    def dense(fan_in, *shape):
        w = np.clip(rng.standard_normal(shape), -2, 2) / np.sqrt(fan_in)
        return w.astype(np.float32)

    def scale(*shape):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    return {
        "embed": {"table": (0.02 * rng.standard_normal((cfg.vocab, D)))
                  .astype(np.float32)},
        "blocks": {
            "ln_attn": {"scale": scale(L, D)},
            "attn": {"wq": dense(D, L, D, H * hd),
                     "wk": dense(D, L, D, kvH * hd),
                     "wv": dense(D, L, D, kvH * hd),
                     "wo": dense(H * hd, L, H * hd, D)},
            "ln_mlp": {"scale": scale(L, D)},
            "mlp": {"w_gate": dense(D, L, D, Fd),
                    "w_up": dense(D, L, D, Fd),
                    "w_down": dense(Fd, L, Fd, D)},
        },
        "ln_f": {"scale": scale(D)},
    }


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

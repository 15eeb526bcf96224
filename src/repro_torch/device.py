"""Device resolution for the port's entry points.

The rule: an entry point runs on the GPU (``"cuda"``) unless its caller
passes another device, and it raises when the GPU it was asked for is not
there. There is no automatic fallback to the CPU — the CPU is used only when
a caller asks for it (the tests do, with ``device="cpu"``).
"""
from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The device to run on: ``"cuda"`` by default; raises if CUDA is
    requested and absent. On CUDA it also fixes the matmul numerics (see
    :func:`set_numerics`)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on an NVIDIA GPU unless "
                "the caller passes device='cpu'")
        set_numerics()
    return dev


def set_numerics() -> None:
    """Full-precision matmuls, as the JAX package's f32 contractions: no TF32
    for float32 products, and bf16 products reduced in float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def synchronize(dev: torch.device) -> None:
    """Wait for the work queued on ``dev`` (no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

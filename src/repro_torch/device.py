"""Device resolution for the port's entry points.

The rule: an entry point runs on the GPU (``"cuda"``) unless its caller
passes another device, and it raises when the GPU it was asked for is not
there. There is no automatic fallback to the CPU — the CPU is used only when
a caller asks for it (the tests do, with ``device="cpu"``).

A rank of a ``torch.distributed`` run takes its device and its collectives
backend by one rule (:func:`rank_device`, :func:`dist_backend`), decided
from the world size and the card count, never by catching a failure.
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


def rank_device(device, local_rank: int) -> torch.device:
    """A rank's device: ``device`` resolved as above; a CUDA rank without an
    index takes card ``local_rank % card count`` (ranks share the cards when
    there are more of them than cards) and makes it the current card."""
    dev = resolve(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def dist_backend(device: torch.device, world: int) -> str:
    """The collectives backend of a ``world``-rank run on ``device``: gloo
    for CPU ranks; NCCL for CUDA ranks when the world has no more ranks
    than cards (NCCL refuses two ranks on one card); otherwise gloo, which
    takes CUDA tensors for every collective the protocol makes
    (``all_gather_into_tensor``, ``all_to_all_single``, ``broadcast``), so
    no tensor is staged through the host."""
    if torch.device(device).type == "cpu":
        return "gloo"
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


def card_route(t: torch.Tensor) -> bool:
    """True where a tensor takes the card's route through the hand-written
    kernels: a CUDA tensor, or a ``meta`` tensor (shapes alone: the dry
    run follows the card's routes, and each kernel wrapper answers it with
    its output shapes and its count of work, never with a plain version).
    A CPU tensor takes the plain route; any other device raises where a
    kernel wrapper checks it."""
    return t.is_cuda or t.is_meta


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

"""repro_torch.checkpoint — the JAX package's checkpoint format (one ``.npy``
per leaf, ``manifest.json``, atomic rename) for the port's states."""
from . import checkpointer

__all__ = ["checkpointer"]

"""The test oracle of the WKV scan's chunk recurrence: the loop that
``repro_torch.models.rwkv6.wkv_chunked`` ran before the kernels, with
autograd through it."""
from __future__ import annotations

import torch


def state_scan_ref(decay, add, s0):
    """``decay [N, B, H, K]``, ``add [N, B, H, K, V]``, ``s0 [B, H, K, V]``
    -> ``(entering [N, B, H, K, V], final [B, H, K, V])``, from ``s = s0``:
    ``entering[i] = s``, then ``s = decay[i] * s + add[i]``."""
    s = s0
    entering = []
    for i in range(add.shape[0]):
        entering.append(s)
        s = decay[i][..., None] * s + add[i]
    return torch.stack(entering), s

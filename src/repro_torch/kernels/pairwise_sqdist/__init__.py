"""Gram matrices and pairwise squared distances: CUDA kernel
(``csrc/gram.cu``), wrapper and plain version (``ops.py``), the
Gram-to-distance step (``ref.py``)."""

"""Flash-attention forward: CUDA kernel (``csrc/flash_fwd.cu``), wrapper and
plain version (``ops.py``), oracle (``ref.py``)."""

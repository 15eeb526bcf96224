"""Coordinate-wise median: CUDA kernel (``csrc/cwise_median.cu``), wrapper
and plain version (``ops.py``), oracle (``ref.py``)."""

"""The WKV scan's chunk recurrence: the forward and backward CUDA kernels
(``csrc/wkv_scan.cu``), their wrappers and the ``torch.autograd.Function``
that pairs them (``ops.py``), the test oracle (``ref.py``)."""

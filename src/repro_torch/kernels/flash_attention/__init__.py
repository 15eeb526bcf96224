"""Flash attention: the forward and backward CUDA kernels
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``), their wrappers and the
``torch.autograd.Function`` that pairs them (``ops.py``), the plain versions
and oracle (``ref.py``)."""

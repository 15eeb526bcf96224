"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

The port mirrors the JAX package's layout (``models/``, ``kernels/<pkg>/``,
``agg/``, ``core/``, ``exp/``, ``data/``, ``optim/``, ``configs/``,
``serve/``, ``launch/``) with the same module and function names. Plain tensor code is PyTorch; every Pallas TPU kernel on a
ported path is a hand-written CUDA C++ kernel for ``sm_90a`` under
``kernels/<pkg>/csrc/``, built with ``nvcc`` at first use.

Device rule (:mod:`repro_torch.device`): entry points run on the GPU unless
the caller passes ``device="cpu"``. A kernel wrapper runs its plain PyTorch
version only for a tensor that lies on the CPU; for a CUDA tensor it
launches the kernel or raises.
"""

"""Hand-written Hopper kernels (CUDA C++ for ``sm_90a``), one package per
Pallas TPU kernel package of ``repro.kernels``.

Each package holds ``csrc/*.cu`` (a plain C entry point per kernel), an
``ops.py`` wrapper that launches the kernel for a CUDA tensor and runs the
plain PyTorch version for a CPU tensor, and ``ref.py`` (the test oracle).
Sources are compiled with ``nvcc`` into a shared library at first use and
loaded with ``ctypes`` (:mod:`repro_torch.kernels._build`).
"""

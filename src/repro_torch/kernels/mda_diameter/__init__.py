"""Exact MDA selection (the subset diameters, their first argmin and the
weights): CUDA kernel (``csrc/mda_diameter.cu``), wrappers and plain
versions (``ops.py``); the test oracle is ``repro_torch.agg.rules``."""

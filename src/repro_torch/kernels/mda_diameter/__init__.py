"""Subset diameters for exact MDA selection: CUDA kernel
(``csrc/mda_diameter.cu``), wrapper and plain version (``ops.py``); the
test oracle is ``repro_torch.agg.rules.subset_diameters``."""

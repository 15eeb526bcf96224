"""The most device memory the run's tensors held at once, over set-up and
the window (``torch.cuda.max_memory_allocated``), in GB of 1e9 bytes."""

UNIT = "GB"


def read(run):
    return run.memory_peak_bytes / 1e9 if run.memory_peak_bytes else None

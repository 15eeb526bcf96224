"""Seconds from the process's start to the window's: imports, the CUDA
context, loading (on a checkout's first run, building) the kernel
libraries, the initial model, the step's buffers, and the checked steps,
which warm every shape the window runs (the last of them gathers)."""

UNIT = "s"


def read(run):
    return run.setup_s

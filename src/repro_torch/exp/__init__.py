"""repro_torch.exp — the declarative Experiment API of ``repro.exp`` for the
single-host runners::

    import repro_torch.exp as exp

    res = exp.run("quickstart")                          # on the GPU
    res = exp.run("smoke", device="cpu")                 # on the CPU
    res = exp.run("quickstart", model="mlp_h1024", steps=150)
    exp.Experiment.from_dict(e.to_dict()) == e           # exact round trip
    e.spec_hash                                          # = the JAX hash
"""
from __future__ import annotations

from . import presets, runners, spec  # noqa: F401
from .presets import get, names, register
from .runners import RunResult, git_sha, provenance, run
from .spec import DATA, MODELS, SCHEDULES, Experiment

__all__ = ["DATA", "Experiment", "MODELS", "RunResult", "SCHEDULES", "get",
           "git_sha", "names", "presets", "provenance", "register", "run",
           "runners", "spec"]

"""repro_torch.exp — the declarative Experiment API of ``repro.exp``::

    import repro_torch.exp as exp

    res = exp.run("quickstart")                          # on the GPU
    res = exp.run("smoke", device="cpu")                 # on the CPU
    res = exp.run("quickstart", model="mlp_h1024", steps=150)
    res = exp.run("netsim/crash_storm", device="cpu")    # over a netsim trace
    exp.Experiment.from_dict(e.to_dict()) == e           # exact round trip
    e.spec_hash                                          # = the JAX hash

``python -m repro_torch.exp`` prints the runners, models and preset tables.
"""
from __future__ import annotations

from . import presets, runners, spec  # noqa: F401
from .presets import (get, markdown_table, models_table, names, register,
                      runners_table, specs)
from .runners import RunResult, git_sha, provenance, run, write_result
from .spec import DATA, MODELS, SCHEDULES, Experiment

__all__ = ["DATA", "Experiment", "MODELS", "RunResult", "SCHEDULES", "get",
           "git_sha", "markdown_table", "models_table", "names", "presets",
           "provenance", "register", "run", "runners", "runners_table",
           "spec", "specs", "write_result"]

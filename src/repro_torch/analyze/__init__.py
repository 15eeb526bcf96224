"""``repro_torch.analyze`` — the port's repo-invariant lint, its run on
the CPU and its check on the card.

The port of ``repro.analyze``, module for module, importing nothing of the
reference. The port's claims live in three places: the source (Table-1
bounds in every preset, Byzantine taint laundered by a robust GAR, no
host syncs in the step loops, the CUDA sources' grids, guards,
accumulators and NaN sentinels, the kernels' build key), a run on the
CPU (the state updated in place, the collectives' bytes by tag equal to
their formulas) and a run on the card (one device->host copy per engine
run, no sync inside an epoch). ``python -m repro_torch.analyze`` checks
the first by parsing — never importing — the port (layer 1); ``--run``
adds layer 2 and ``--card`` layer 3. The lint gates on the committed
baseline (``results/analyze_torch/baseline.json``); see the README's
"Static analysis of the port" for the rule table.
"""
from __future__ import annotations

from .astlint import LINT_ROOTS, lint_file, lint_paths, lint_repo
from .findings import (BASELINE_PATH, REPORT_PATH, Finding, load_baseline,
                       load_entries, markdown_report, split_baselined,
                       to_report, write_baseline, write_report)
from .registry import Rule, get, markdown_table, register, rules

__all__ = [
    "BASELINE_PATH", "Finding", "LINT_ROOTS", "REPORT_PATH", "Rule", "get",
    "lint_file", "lint_paths", "lint_repo", "load_baseline", "load_entries",
    "markdown_report", "markdown_table", "register", "rules",
    "split_baselined", "to_report", "write_baseline", "write_report",
]

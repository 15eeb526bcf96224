"""Pluggable rule registry for ``repro_torch.analyze``.

A :class:`Rule` couples an id with a checker:

* ``scope="file"`` — ``check(tree, source, path) -> [Finding]`` runs once
  per linted file with its parsed AST (layer 1; never imports the checked
  code).
* ``scope="repo"`` — ``check(root) -> [Finding]`` runs once against the
  repo root (cross-file invariants: presets vs quorum bounds, registry vs
  tests parity, the CUDA sources and their build).
* ``scope="run"`` — ``check(root) -> [Finding]`` runs only under ``--run``
  (layer 2; imports the port and runs the ``smoke`` preset on the CPU).
* ``scope="card"`` — ``check(root) -> [Finding]`` runs only under
  ``--card`` (layer 3; needs a CUDA device and raises without one).

Rules register at import of :mod:`repro_torch.analyze.rules`. The table
printed by ``python -m repro_torch.analyze --table`` (and embedded in the
README) is derived from this registry, so it cannot go stale.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

_RULES: dict[str, "Rule"] = {}

SCOPES = ("file", "repo", "run", "card")
_LAYER = {"file": "1 (AST)", "repo": "1 (AST)", "run": "2 (run, CPU)",
          "card": "3 (card)"}

#: the reference's rules with no counterpart here, and why (the notes
#: under the rule table)
NOT_PORTED = {
    "REPRO-CACHE-KEY": "the port has no compiled-epoch cache "
                       "(`core/epochs.py` is not ported); the kernels' "
                       "build cache is checked by `REPRO-BUILD-KEY`",
    "REPRO-PALLAS-*": "the port has no Pallas kernels; `REPRO-CUDA-GRID`, "
                      "`-GUARD` (for `-OOB`), `-ACC` and `-MASK` audit the "
                      "CUDA sources",
    "REPRO-HLO-DONATION": "eager PyTorch compiles no executable; "
                          "`REPRO-RUN-INPLACE` checks that the state keeps "
                          "its storages",
    "REPRO-HLO-HOST-TRANSFER": "counted on the card by "
                               "`REPRO-CARD-HOST-TRANSFER`",
    "REPRO-HLO-RECOMPILE": "no compiled artifact and no compile cache "
                           "(`launch/hlo_analysis.py` is not ported)",
    "REPRO-HLO-COLLECTIVES": "no HLO text to audit; "
                             "`REPRO-RUN-COLLECTIVES` counts what the "
                             "port's collectives pass",
}


@dataclasses.dataclass(frozen=True)
class Rule:
    rule_id: str
    scope: str                      # one of SCOPES
    description: str                # one line, for the table
    check: Callable
    fix_hint: str = ""


def register(rule: Rule) -> Rule:
    if rule.scope not in SCOPES:
        raise ValueError(f"bad scope {rule.scope!r} for {rule.rule_id}")
    if rule.rule_id in _RULES:
        raise ValueError(f"duplicate rule id {rule.rule_id}")
    _RULES[rule.rule_id] = rule
    return rule


def get(rule_id: str) -> Rule:
    _ensure_loaded()
    return _RULES[rule_id]


def rules(scope: str | None = None) -> list[Rule]:
    _ensure_loaded()
    out = sorted(_RULES.values(), key=lambda r: r.rule_id)
    if scope is not None:
        out = [r for r in out if r.scope == scope]
    return out


def _ensure_loaded() -> None:
    # registration side effect. importlib, not `from . import rules`: the
    # package re-exports the rules() *function*, which would shadow the
    # subpackage in an attribute-style import and silently skip loading.
    import importlib
    importlib.import_module(".rules", __package__)


def markdown_table() -> str:
    """Rule table for --table / README (derived, never hand-maintained),
    with the reference's rules that are not ported as notes."""
    _ensure_loaded()
    lines = ["| rule | layer | checks |", "|---|---|---|"]
    for r in rules():
        lines.append(f"| `{r.rule_id}` | {_LAYER[r.scope]} | "
                     f"{r.description} |")
    lines.append("")
    lines.append("Not ported from `repro.analyze`:")
    for rid, why in NOT_PORTED.items():
        lines.append(f"- `{rid}`: {why}.")
    return "\n".join(lines)

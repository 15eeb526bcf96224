"""Findings, suppressions, baselines and report writers for
``repro_torch.analyze`` — the reference's mechanics, with the port's paths.

A :class:`Finding` is one violation: rule id + file:line + message + fix
hint. Three mechanisms keep the repo at zero *reported* violations:

* **inline suppression** — a ``# analyze: ignore[RULE-ID] <justification>``
  comment on the flagged line (or the line above it). The justification is
  mandatory; a bare ``ignore[...]`` is itself reported (REPRO-SUPPRESS).
* **baseline** — ``results/analyze_torch/baseline.json`` holds known
  findings (keyed on rule id + path + message, NOT line numbers, so
  unrelated edits don't churn it), each with the ``reason`` it is kept.
  ``python -m repro_torch.analyze --update-baseline`` rewrites it from the
  current findings, keeping the reasons of the entries it keeps, and
  prunes stale entries (vanished files, unregistered rule ids), keeping
  entries from scopes the run skipped. An entry it adds has an empty
  reason, which the CLI reports until one is written.
* the fix itself, which is always preferred.

Reports: ``to_report()`` builds the JSON document written to
``results/analyze_torch/report.json`` (with the port's provenance block)
and ``markdown_report()`` the human table.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os
import re
import tokenize

BASELINE_PATH = os.path.join("results", "analyze_torch", "baseline.json")
REPORT_PATH = os.path.join("results", "analyze_torch", "report.json")

_SUPPRESS_RE = re.compile(
    r"#\s*analyze:\s*ignore\[(?P<rules>[A-Z0-9\-,\s]+)\]\s*(?P<why>.*)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation. ``line`` is 1-based; 0 means whole-file/repo scope."""
    rule_id: str
    path: str
    line: int
    message: str
    fix_hint: str = ""

    @property
    def key(self) -> str:
        """Baseline identity: stable across unrelated line-number churn."""
        return f"{self.rule_id}::{self.path}::{self.message}"

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        out = f"{loc}: [{self.rule_id}] {self.message}"
        if self.fix_hint:
            out += f"\n    fix: {self.fix_hint}"
        return out

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# inline suppressions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Suppression:
    line: int
    rules: tuple[str, ...]
    justification: str


def scan_suppressions(source: str, path: str) -> tuple[dict, list[Finding]]:
    """Map line -> Suppression from ``# analyze: ignore[...]`` comments.

    Comments are found with :mod:`tokenize` (not a regex over the raw line)
    so string literals that merely *contain* the marker don't suppress.
    A suppression with an empty justification yields a REPRO-SUPPRESS
    finding — suppressing without saying why is itself a violation.
    """
    sups: dict[int, Suppression] = {}
    bad: list[Finding] = []
    try:
        toks = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in toks:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            rules = tuple(r.strip() for r in m.group("rules").split(",")
                          if r.strip())
            why = m.group("why").strip()
            sup = Suppression(tok.start[0], rules, why)
            sups[tok.start[0]] = sup
            if not why:
                bad.append(Finding(
                    "REPRO-SUPPRESS", path, tok.start[0],
                    f"suppression of {', '.join(rules)} has no justification",
                    "append a reason: `# analyze: ignore[RULE] because ...`"))
    except tokenize.TokenError:
        pass
    return sups, bad


def is_suppressed(finding: Finding, sups: dict) -> bool:
    """A finding is suppressed by a marker on its line or the line above."""
    for ln in (finding.line, finding.line - 1):
        sup = sups.get(ln)
        if sup and sup.justification and finding.rule_id in sup.rules:
            return True
    return False


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------


def load_entries(path: str = BASELINE_PATH) -> list[dict]:
    """The baseline's entries: ``{"key", "fix_hint", "reason"}`` each."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return json.load(f).get("findings", [])


def load_baseline(path: str = BASELINE_PATH) -> set[str]:
    return {e["key"] for e in load_entries(path)}


_COMMENT = ("Known repro_torch.analyze findings kept out of the exit-code "
            "gate, each with the reason it is kept (a port fault or a speed "
            "finding also stands in ROADMAP.md). Keep this short; prefer "
            "fixes or inline `# analyze: ignore[RULE] why` suppressions.")


def _write(entries: list[dict], path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    doc = {"comment": _COMMENT,
           "findings": sorted(entries, key=lambda e: e["key"])}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    return path


def write_baseline(findings: list[Finding], path: str = BASELINE_PATH) -> str:
    return _write([{"key": f.key, "fix_hint": f.fix_hint, "reason": ""}
                   for f in findings], path)


def refresh_baseline(findings: list[Finding], path: str, root: str,
                     scopes_run: set[str],
                     rule_scopes: dict[str, str]) -> tuple[str, list[str]]:
    """Rewrite the baseline from the current findings, keeping entries
    from scopes that were not run this invocation (e.g. card without
    ``--card``), keeping each kept key's reason, and pruning stale ones
    whose rule id is no longer registered or whose file no longer exists.

    Returns ``(path, pruned_keys)``.
    """
    kept: list[dict] = []
    pruned: list[str] = []
    reasons: dict[str, str] = {}
    for e in load_entries(path):
        rid, _, rest = e["key"].partition("::")
        fpath, _, _ = rest.partition("::")
        scope = rule_scopes.get(rid)
        if scope is None or not os.path.exists(os.path.join(root, fpath)):
            pruned.append(e["key"])
            continue
        reasons[e["key"]] = e.get("reason", "")
        if scope not in scopes_run:
            kept.append(e)
    entries = {e["key"]: e for e in kept}
    for f in findings:
        entries[f.key] = {"key": f.key, "fix_hint": f.fix_hint,
                          "reason": reasons.get(f.key, "")}
    return _write(list(entries.values()), path), pruned


def split_baselined(findings: list[Finding],
                    baseline: set[str]) -> tuple[list[Finding], list[Finding]]:
    """(new, known) partition against the baseline key set."""
    new = [f for f in findings if f.key not in baseline]
    known = [f for f in findings if f.key in baseline]
    return new, known


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------


def to_report(findings: list[Finding], known: list[Finding],
              stats: dict | None = None) -> dict:
    """report.json document, with the port's provenance block
    (``repro_torch.exp.runners.provenance``)."""
    try:
        import hashlib

        import torch

        from ..exp.runners import provenance
        blob = json.dumps({"lane": "analyze_torch"}, sort_keys=True)
        prov = provenance(hashlib.sha256(blob.encode()).hexdigest()[:16],
                          torch.device("cpu"))
    except Exception:  # the report is written whatever the import costs
        prov = {}
    return {
        "violations": [f.to_dict() for f in findings],
        "baselined": [f.to_dict() for f in known],
        "stats": stats or {},
        "clean": not findings,
        "provenance": prov,
    }


def write_report(doc: dict, path: str = REPORT_PATH) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, default=float)
        f.write("\n")
    return path


def markdown_report(findings: list[Finding]) -> str:
    if not findings:
        return "no violations"
    lines = ["| rule | location | message |", "|---|---|---|"]
    for f in sorted(findings, key=lambda f: (f.rule_id, f.path, f.line)):
        loc = f"{f.path}:{f.line}" if f.line else f.path
        lines.append(f"| {f.rule_id} | `{loc}` | {f.message} |")
    return "\n".join(lines)

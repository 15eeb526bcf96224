"""CLI: ``python -m repro_torch.analyze [--run] [--card] [--table]
[--json PATH] [--update-baseline] [--fast] [--root DIR]``.

Layer 1 (AST lint, CUDA-source audit, repo invariants) always runs and
never imports the checked code. ``--run`` adds layer 2 (the ``smoke``
preset run on the CPU); ``--card`` adds layer 3 (the engines on a CUDA
device; it raises without one). Exit status 1 iff any finding is neither
inline-suppressed nor in the committed baseline, or a baselined finding
has no reason — the ``make lint-torch`` contract.
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analyze",
        description="the port's repo-invariant lint (layer 1), its run on "
                    "the CPU (layer 2, --run) and on the card (layer 3, "
                    "--card)")
    ap.add_argument("--run", action="store_true",
                    help="also run the layer-2 rules (imports the port and "
                         "runs the smoke preset on the CPU)")
    ap.add_argument("--card", action="store_true",
                    help="also run the layer-3 rules (needs a CUDA device)")
    ap.add_argument("--table", action="store_true",
                    help="print the rule table (README format) and exit")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the findings report JSON here")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite results/analyze_torch/baseline.json from "
                         "the current findings, pruning stale entries, "
                         "keeping reasons and scopes not run (keep it "
                         "short; prefer fixes)")
    ap.add_argument("--fast", action="store_true",
                    help="lint only the git-changed files (file-scope "
                         "rules) and scope the interprocedural taint "
                         "analysis to their call-graph component")
    ap.add_argument("--root", default=None,
                    help="repo root (default: cwd, or the checkout "
                         "containing this package)")
    args = ap.parse_args(argv)

    from . import findings as F
    from . import registry
    from .astlint import lint_paths, lint_repo

    if args.table:
        print(registry.markdown_table())
        return 0

    root = args.root or _find_root()
    changed = _changed_files(root) if args.fast else None
    if args.fast:
        from .rules import taint_byz
        taint_byz.scope_to(changed)
    found = lint_repo(root, only_files=changed)
    scopes = {"file", "repo"}
    for flag, scope in ((args.run, "run"), (args.card, "card")):
        if flag:
            scopes.add(scope)
            for rule in registry.rules(scope=scope):
                found.extend(rule.check(root))

    base_path = os.path.join(root, F.BASELINE_PATH)
    baseline = F.load_baseline(base_path)
    new, known = F.split_baselined(found, baseline)
    unexplained = [e["key"] for e in F.load_entries(base_path)
                   if not e.get("reason", "").strip()]
    stats = {"rules_run": [r.rule_id for r in registry.rules()
                           if r.scope in scopes],
             "files_linted": len(lint_paths(root)),
             "run": bool(args.run), "card": bool(args.card)}

    if args.update_baseline:
        rule_scopes = {r.rule_id: r.scope for r in registry.rules()}
        path, pruned = F.refresh_baseline(found, base_path, root, scopes,
                                          rule_scopes)
        note = f" ({len(pruned)} stale entries pruned)" if pruned else ""
        print(f"baseline: {len(found)} finding(s) -> {path}{note}")
        return 0

    if args.json:
        F.write_report(F.to_report(new, known, stats), args.json)

    for f in new:
        print(f.format())
    for key in unexplained:
        print(f"baseline entry without a reason: {key}")
    if known:
        print(f"({len(known)} baselined finding(s) suppressed)")
    layers = "layers 1" + (", 2" if args.run else "") + (
        ", 3" if args.card else "")
    if new or unexplained:
        print(f"\n{len(new)} violation(s), {len(unexplained)} baseline "
              f"entries without a reason ({layers})")
        return 1
    print(f"clean ({layers}; {len(stats['rules_run'])} rules run)")
    return 0


def _changed_files(root: str) -> set[str] | None:
    """Rel paths changed vs HEAD (`--fast` scope); None -> full analysis."""
    import subprocess
    try:
        out = subprocess.run(
            ["git", "diff", "--name-only", "HEAD"],
            cwd=root, capture_output=True, text=True, check=True,
            timeout=10).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return {ln.strip() for ln in out.splitlines()
            if ln.strip().endswith(".py")}


def _find_root() -> str:
    """cwd if it holds the port, else the checkout above src/."""
    cwd = os.getcwd()
    if os.path.isdir(os.path.join(cwd, "src", "repro_torch")):
        return cwd
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


if __name__ == "__main__":
    sys.exit(main())

"""Layer-1 driver: walk the lint roots, parse, run file/repo rules.

Purely static — this module never imports the code it checks. The lint
roots are the port's own code: the package, ``tools/`` and
``chip_smoke.py``. Fixture trees (``tests/``) are excluded so
rule-tripping fixtures in ``tests/test_torch_analyze.py`` don't flag the
repo; the analyzer package itself IS linted (rules quote sync-call names
as strings, not calls, precisely so they pass their own checks).
"""
from __future__ import annotations

import ast
import os

from .findings import Finding, is_suppressed, scan_suppressions
from .registry import rules

LINT_ROOTS = ("src/repro_torch", "tools", "chip_smoke.py")
_SKIP_DIRS = {"__pycache__", ".git", "results", "build"}


def lint_paths(root: str) -> list[str]:
    out = []
    for lr in LINT_ROOTS:
        base = os.path.join(root, lr)
        if os.path.isfile(base) and base.endswith(".py"):
            out.append(base)
            continue
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    out.append(os.path.join(dirpath, fn))
    return sorted(out)


def lint_file(path: str, root: str, source: str | None = None,
              scoped_rules=None) -> list[Finding]:
    """Run every file-scope rule on one file; apply inline suppressions."""
    if source is None:
        with open(path) as f:
            source = f.read()
    rel = os.path.relpath(path, root)
    try:
        tree = ast.parse(source, filename=rel)
    except SyntaxError as e:
        return [Finding("REPRO-PARSE", rel, e.lineno or 0,
                        f"file does not parse: {e.msg}")]
    sups, bad_sups = scan_suppressions(source, rel)
    found: list[Finding] = list(bad_sups)
    for rule in (scoped_rules if scoped_rules is not None
                 else rules(scope="file")):
        for f in rule.check(tree, source, rel):
            if not is_suppressed(f, sups):
                found.append(f)
    return found


def lint_repo(root: str, include_repo_rules: bool = True,
              only_files: set[str] | None = None) -> list[Finding]:
    """Layer 1 over the whole tree: all file rules + repo-scope rules.

    Repo-scope findings honor inline suppressions too: each finding is
    attributed to a file:line (e.g. a preset registration line), and a
    ``# analyze: ignore[RULE-ID] why`` on that line suppresses it.

    ``only_files`` (rel paths) restricts the *file-scope* pass — the
    ``--fast`` pre-commit lane lints only the changed files; repo-scope
    rules are whole-tree invariants and always see everything.
    """
    found: list[Finding] = []
    for path in lint_paths(root):
        if (only_files is not None
                and os.path.relpath(path, root) not in only_files):
            continue
        found.extend(lint_file(path, root))
    if include_repo_rules:
        sup_cache: dict[str, list] = {}
        for rule in rules(scope="repo"):
            for f in rule.check(root):
                if f.path not in sup_cache:
                    fpath = os.path.join(root, f.path)
                    try:
                        with open(fpath) as fh:
                            src = fh.read()
                        sup_cache[f.path], _ = scan_suppressions(src, f.path)
                    except OSError:
                        sup_cache[f.path] = {}
                if not is_suppressed(f, sup_cache[f.path]):
                    found.append(f)
    return found


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------


def call_name(node: ast.Call) -> str:
    """Dotted name of a call target: ``torch.cuda.synchronize`` ->
    'torch.cuda.synchronize'."""
    return dotted_name(node.func)


def dotted_name(node: ast.AST) -> str:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def literal_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None

"""REPRO-DEAD-SEED: ``src/repro_torch`` modules nothing imports.

A module nobody imports is invisible debt: it rots silently,
REPRO-AGG-PARITY never sees it, and the roadmap item looks done because
the file exists. This repo rule lists every ``src/repro_torch`` module that
no file under the lint roots imports — baselined with its reason, so
tracked debt is explicit and *new* dead modules fail the lint.

What counts as "imported": static imports anywhere under the lint roots
(product code — a module only tests import is still dead product
surface), with relative imports resolved against the importing file's
package and function-body imports included (the registry lazy-loads rule
modules that way) — plus dynamic-import evidence: a string literal
``"repro_torch.x.y"`` anywhere (the model registry routes the config and
family modules through ``importlib.import_module`` on such literals).
Exempt, as in the reference: ``__init__.py`` / ``__main__.py``, modules
with an ``if __name__ == "__main__"`` guard (CLI entry points, run via
``python -m``), the kernel packages' ``ref.py`` reference oracles
(consumed by the tier-1 suite by convention) — and, the port's own
oracle loader, ``models/convert.py``, which maps the reference's
parameter layouts onto the port's for the parity tests.
"""
from __future__ import annotations

import ast
import os
import re

from ..findings import Finding
from ..registry import Rule, register

_SRC_PREFIX = os.path.join("src", "repro_torch")
_EXEMPT = {"__init__.py", "__main__.py", "ref.py"}
#: the oracle loader: only the parity tests import it, by design
_EXEMPT_PATHS = {os.path.join(_SRC_PREFIX, "models", "convert.py")}
_MODULE_LIT = re.compile(r"^repro_torch(\.\w+)+$")


def _module_name(rel: str) -> str:
    """src/repro_torch/core/compression.py -> repro_torch.core.compression"""
    no_src = os.path.relpath(rel, "src")
    return no_src[:-3].replace(os.sep, ".")


def _package_of(rel: str) -> str:
    """Dotted package containing the file (for relative-import resolve)."""
    return _module_name(rel).rsplit(".", 1)[0]


def _imports_of(tree: ast.Module, pkg: str) -> set[str]:
    """All dotted module names a file imports: absolute + resolved
    relative + string-literal dynamic-import evidence."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out.add(alias.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                parts = pkg.split(".")
                if node.level > 1:
                    parts = parts[:len(parts) - (node.level - 1)]
                base = ".".join(parts)
                mod = f"{base}.{node.module}" if node.module else base
            else:
                mod = node.module or ""
            out.add(mod)
            for alias in node.names:
                out.add(f"{mod}.{alias.name}")
        elif (isinstance(node, ast.Constant)
              and isinstance(node.value, str)
              and _MODULE_LIT.match(node.value)):
            out.add(node.value)         # importlib.import_module target
    return out


def _has_main_guard(tree: ast.Module) -> bool:
    for node in tree.body:
        if (isinstance(node, ast.If)
                and "__main__" in ast.unparse(node.test)):
            return True
    return False


def check(root: str) -> list[Finding]:
    from ..astlint import lint_paths
    seeded: dict[str, str] = {}          # dotted name -> rel path
    imported: set[str] = set()
    for path in lint_paths(root):
        rel = os.path.relpath(path, root)
        try:
            with open(path) as f:
                tree = ast.parse(f.read(), filename=rel)
        except SyntaxError:
            continue                    # REPRO-PARSE reports it
        if rel.startswith(_SRC_PREFIX + os.sep):
            if (os.path.basename(rel) not in _EXEMPT
                    and rel not in _EXEMPT_PATHS
                    and not _has_main_guard(tree)):
                seeded[_module_name(rel)] = rel
            imported |= _imports_of(tree, _package_of(rel))
        else:
            imported |= _imports_of(tree, "")
    found = []
    for mod, rel in sorted(seeded.items()):
        if mod in imported:
            continue
        found.append(Finding(
            "REPRO-DEAD-SEED", rel, 1,
            f"module `{mod}` is seeded but never imported from the lint "
            "roots — tracked debt until its roadmap item lands",
            "wire it into its package (or delete it and drop the roadmap "
            "item); baseline it while the item is pending"))
    return found


register(Rule(
    rule_id="REPRO-DEAD-SEED",
    scope="repo",
    description="every src/repro_torch module is imported somewhere under "
                "the lint roots; dead modules are baselined debt",
    check=check,
    fix_hint="import the module where its roadmap item lands, or delete it",
))

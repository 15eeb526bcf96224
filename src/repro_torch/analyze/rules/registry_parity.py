"""REPRO-AGG-PARITY: every registered Aggregator is fully wired.

Cross-file consistency of the port's GAR registry, from ASTs alone:

* **backend parity** — a spec declaring a CUDA backend
  (``backends=( .., _CUDA_*)``, a ``"cuda (...)"`` route naming its kernel
  packages) must route through a ``dispatch.<fn>`` entry point that
  exists in ``agg/dispatch.py`` (the dispatch level picks the kernel or
  the plain version by the tensor's device);
* **masked-delivery wiring** — a declared ``masked_fn``/
  ``weights_from_d2`` must exist in ``agg/rules.py`` (or, spelled
  ``dispatch.<fn>``, in ``agg/dispatch.py``);
* **__main__ table row** — ``agg/__main__.py`` must print
  ``markdown_table``, and ``markdown_table`` must derive its rows from
  ``specs()`` (so a new rule cannot ship without a docs row);
* **masked-delivery property test** — ``tests/test_torch_agg.py`` must
  either name the rule literally or build its rule list dynamically from
  the registry (``names()``/``specs()`` + ``supports_masked_delivery``),
  so a new masked-capable rule is automatically under test.
"""
from __future__ import annotations

import ast
import os

from ..astlint import dotted_name, literal_str
from ..findings import Finding
from ..registry import Rule, register

_REGISTRY = os.path.join("src", "repro_torch", "agg", "registry.py")
_DISPATCH = os.path.join("src", "repro_torch", "agg", "dispatch.py")
_RULES = os.path.join("src", "repro_torch", "agg", "rules.py")
_MAIN = os.path.join("src", "repro_torch", "agg", "__main__.py")
_TESTS = os.path.join("tests", "test_torch_agg.py")


def _parse(root: str, rel: str) -> ast.Module | None:
    path = os.path.join(root, rel)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return ast.parse(f.read(), filename=rel)


def _top_level_defs(tree: ast.Module) -> set[str]:
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _module_strs(tree: ast.Module) -> dict[str, str]:
    """Module-level ``NAME = "literal"`` (the ``_CUDA_*`` routes)."""
    out = {}
    for stmt in tree.body:
        if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
                and literal_str(stmt.value) is not None):
            out[stmt.targets[0].id] = literal_str(stmt.value)
    return out


def _backends(node: ast.AST, consts: dict[str, str]) -> tuple[str, ...]:
    if not isinstance(node, (ast.Tuple, ast.List)):
        return ()
    out = []
    for el in node.elts:
        val = literal_str(el)
        if val is None and isinstance(el, ast.Name):
            val = consts.get(el.id)
        if val is not None:
            out.append(val)
    return tuple(out)


def _agg_specs(tree: ast.Module):
    """(kwargs-dict of ast nodes, lineno) per register(Aggregator(...))."""
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "register"):
            continue
        for arg in node.args:
            if (isinstance(arg, ast.Call) and isinstance(arg.func, ast.Name)
                    and arg.func.id == "Aggregator"):
                yield {kw.arg: kw.value for kw in arg.keywords
                       if kw.arg}, arg.lineno


def check(root: str) -> list[Finding]:
    reg = _parse(root, _REGISTRY)
    if reg is None:
        return [Finding("REPRO-AGG-PARITY", _REGISTRY, 0,
                        "agg/registry.py not found")]
    dispatch_defs = _top_level_defs(_parse(root, _DISPATCH) or ast.Module([], []))
    rules_defs = _top_level_defs(_parse(root, _RULES) or ast.Module([], []))
    consts = _module_strs(reg)
    found: list[Finding] = []

    test_src = ""
    tpath = os.path.join(root, _TESTS)
    if os.path.exists(tpath):
        with open(tpath) as f:
            test_src = f.read()
    dynamic_tests = ("supports_masked_delivery" in test_src
                     and ("names()" in test_src or "specs()" in test_src))

    n_specs = 0
    for kw, lineno in _agg_specs(reg):
        n_specs += 1
        name = literal_str(kw.get("name")) or f"<spec@{lineno}>"
        backends = _backends(kw.get("backends"), consts)
        fn = dotted_name(kw.get("fn")) if "fn" in kw else ""
        if any(b.startswith("cuda") for b in backends):
            head, _, attr = fn.rpartition(".")
            if head != "dispatch" or attr not in dispatch_defs:
                found.append(Finding(
                    "REPRO-AGG-PARITY", _REGISTRY, lineno,
                    f"aggregator `{name}` declares a cuda backend but "
                    f"fn={fn or '?'} is not a dispatch-level entry point",
                    "route fn through agg/dispatch.py (it picks the kernel "
                    "or the plain version by the tensor's device)"))
        for field in ("masked_fn", "weights_from_d2"):
            if field in kw:
                ref = dotted_name(kw[field])
                head, _, attr = ref.rpartition(".")
                defs, where = ((dispatch_defs, "agg/dispatch.py")
                               if head == "dispatch"
                               else (rules_defs, "agg/rules.py"))
                if head in ("rules", "dispatch") and attr not in defs:
                    found.append(Finding(
                        "REPRO-AGG-PARITY", _REGISTRY, lineno,
                        f"aggregator `{name}`: {field}={ref} not defined "
                        f"in {where}",
                        f"define {attr} in {where} or fix the reference"))
        # masked-delivery property-test coverage
        masked = ("masked_fn" in kw) or ("weights_from_d2" in kw)
        if masked and not dynamic_tests and f'"{name}"' not in test_src \
                and f"'{name}'" not in test_src:
            found.append(Finding(
                "REPRO-AGG-PARITY", _TESTS, 0,
                f"aggregator `{name}` supports masked delivery but "
                "tests/test_torch_agg.py neither names it nor derives its "
                "rule list from the registry",
                "keep the dynamic MASKABLE = [... if "
                "agg.get(n).supports_masked_delivery] idiom"))

    if n_specs == 0:
        found.append(Finding(
            "REPRO-AGG-PARITY", _REGISTRY, 0,
            "no register(Aggregator(...)) calls found — registry structure "
            "changed under the rule",
            "update analyze/rules/registry_parity.py"))

    main = _parse(root, _MAIN)
    main_src = ast.unparse(main) if main else ""
    if "markdown_table" not in main_src:
        found.append(Finding(
            "REPRO-AGG-PARITY", _MAIN, 0,
            "agg/__main__.py no longer prints the registry markdown_table",
            "keep `python -m repro_torch.agg` printing markdown_table()"))
    table_fns = [n for n in reg.body if isinstance(n, ast.FunctionDef)
                 and n.name == "markdown_table"]
    if not table_fns or "specs()" not in ast.unparse(table_fns[0]):
        found.append(Finding(
            "REPRO-AGG-PARITY", _REGISTRY,
            table_fns[0].lineno if table_fns else 0,
            "markdown_table does not derive its rows from specs() — new "
            "aggregators would ship without a docs row",
            "iterate `for s in specs():` inside markdown_table"))
    return found


register(Rule(
    rule_id="REPRO-AGG-PARITY",
    scope="repo",
    description="every `Aggregator` has matching backends (cuda ⇒ "
                "dispatch entry point), existing masked_fn wiring, a "
                "registry-derived `__main__` table row, and masked-delivery "
                "test coverage",
    check=check,
    fix_hint="wire the aggregator through dispatch/rules/tests",
))

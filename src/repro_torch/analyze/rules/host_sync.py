"""REPRO-HOST-SYNC: no host-synchronising calls inside the step loops.

The fused engines promise ONE device->host transfer per ``run`` (the
metric buffers, read once at the end). A ``.item()`` / ``.tolist()`` /
``.cpu()`` / ``.numpy()`` / ``float()``/``int()``/``bool()`` of a tensor
or ``torch.cuda.synchronize`` inside a step stalls the host on the card
once per step, and the card idles while the host catches up.

The functions that run once per step come from the step closure in
``analyze.dataflow``: the ``run_epoch`` bodies of ``EpochEngine`` and
``ProtocolEngine``, closed over the call graph (see
:class:`repro_torch.analyze.dataflow.CallGraph`). A call there is
flagged when it is a sync method, ``torch.cuda.synchronize``, or a
``float``/``int``/``bool`` whose argument holds a tensor expression (a
``torch.*`` call or a tensor method such as ``.all()``/``.sum()``).
Calls in default-argument position are exempt (evaluated at definition
time).
"""
from __future__ import annotations

import ast
import os

from ..astlint import call_name, lint_paths
from ..dataflow import PACKAGE, owner_map, step_functions
from ..findings import Finding
from ..registry import Rule, register

# host-sync call names (module-qualified)
_SYNC_CALLS = {"torch.cuda.synchronize", "cuda.synchronize"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_SCALAR_CASTS = {"float", "int", "bool"}
# methods that make (or only exist on) a tensor: a cast of an expression
# holding one reads the device
_TENSOR_METHODS = {"all", "any", "sum", "mean", "max", "min", "amax", "amin",
                   "argmax", "argmin", "norm", "abs", "count_nonzero",
                   "isnan", "isfinite", "prod", "std", "var"}
_HOST_MODULES = {"np", "numpy", "math", "builtins"}


def _holds_tensor(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if not isinstance(n, ast.Call):
            continue
        name = call_name(n)
        if name.startswith("torch."):
            return True
        if (isinstance(n.func, ast.Attribute)
                and n.func.attr in _TENSOR_METHODS
                and name.partition(".")[0] not in _HOST_MODULES):
            return True
    return False


def _hit(node: ast.Call) -> str | None:
    name = call_name(node)
    if name in _SYNC_CALLS:
        return name
    if (name in _SCALAR_CASTS and node.args
            and not isinstance(node.args[0], ast.Constant)
            and _holds_tensor(node.args[0])):
        return f"{name}()"
    if isinstance(node.func, ast.Attribute) and \
            node.func.attr in _SYNC_METHODS:
        return f".{node.func.attr}()"
    return None


def package_modules(root: str) -> dict[str, ast.Module]:
    """Parse the port's package (the call graph's modules)."""
    modules: dict[str, ast.Module] = {}
    for path in lint_paths(root):
        rel = os.path.relpath(path, root)
        if not rel.startswith(PACKAGE + os.sep):
            continue
        try:
            with open(path) as f:
                modules[rel] = ast.parse(f.read(), filename=rel)
        except SyntaxError:
            continue                    # REPRO-PARSE reports it
    return modules


def check(root: str) -> list[Finding]:
    modules = package_modules(root)
    steps, graph = step_functions(modules)
    if not graph.roots():
        return [Finding("REPRO-HOST-SYNC", PACKAGE, 0,
                        "no step loop found (EpochEngine.run_epoch / "
                        "ProtocolEngine.run_epoch) — the roots moved under "
                        "the rule",
                        "update analyze/dataflow.py ROOTS")]
    found: list[Finding] = []
    for path, tree in sorted(modules.items()):
        owner = owner_map(tree)
        defaults = {id(d) for fn in ast.walk(tree)
                    if isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef, ast.Lambda))
                    for d in fn.args.defaults + fn.args.kw_defaults
                    if d is not None}
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = owner.get(node)
            if fn is None or fn not in steps or id(node) in defaults:
                continue
            hit = _hit(node)
            if hit:
                fname = getattr(fn, "name", "<lambda>")
                found.append(Finding(
                    "REPRO-HOST-SYNC", path, node.lineno,
                    f"host-sync call {hit} inside step function "
                    f"`{fname}`",
                    "keep the value on the device; read it once per run "
                    "with the engine's single host copy"))
    return found


register(Rule(
    rule_id="REPRO-HOST-SYNC",
    scope="repo",
    description="no `.item()`/`.tolist()`/`.cpu()`/`.numpy()`, "
                "`float()`/`int()`/`bool()` of a tensor or "
                "`torch.cuda.synchronize` in the call graph of the "
                "engines' `run_epoch`",
    check=check,
    fix_hint="keep the value on device; one host copy per run",
))

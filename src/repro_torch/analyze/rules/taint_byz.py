"""REPRO-TAINT-BYZ: no unguarded Byzantine influence on model state.

ByzSGD's safety argument is that every value crossing a trust boundary is
laundered through a robust GAR before it touches model state. This rule
*statically proves* it over the whole ``src/repro_torch`` tree with the
interprocedural taint engine (``analyze.dataflow``), as the reference's
does over ``src/repro``:

* **sources** — the cross-node ingress points: ``inject_gradients`` /
  ``inject_models`` (``core/attacks.py``: worker gradient stacks and
  server-model equivocation in ``core/simulator.py`` / ``core/protocol.py``)
  and ``ReplicaPool.corrupt`` (``serve/replica.py``: replica payloads);
* **sanitizers** — exactly the *robust* rules of the port's ``agg``
  registry, derived from its AST: every ``register(Aggregator(...))``
  with a nonzero breakdown point (``requires=(k, c)``, ``k >= 2``), its
  ``masked_fn``, its ``weights_from_d2`` (whose output contracted
  against the stack — ``matmul`` / ``@`` — is the selection-based
  sanitization pattern), plus the registry-level entry points
  ``tree_agg`` / ``selection_weights`` (``agg/tree.py``) and
  ``agg.get(...)`` handles.
  ``mean`` has ``requires=(0, 1)`` and is NOT a sanitizer; a literal
  ``agg.get(name)`` whose spec lacks ``supports_masked_delivery`` does
  not launder a ``mask=`` call either.
* **sinks** — writes into trusted model state: ``params=`` / ``w_model=``
  kwargs of ``SimState`` / ``ByzState`` constructions
  (``core/simulator.py``, ``core/protocol.py``) and ``._replace`` calls,
  and ``checkpoint.save(...)`` payloads (``checkpoint/checkpointer.py``).
  (``ReplicaPool`` is deliberately NOT a sink: replicas model the
  *untrusted* side; serve reads launder through the quorum rules
  instead.)

Every violation prints the witness path file:line by file:line.
"""
from __future__ import annotations

import ast
import os

from ..dataflow import Policy, TaintEngine
from ..findings import Finding
from ..registry import Rule, register

_AGG_REGISTRY = os.path.join("src", "repro_torch", "agg", "registry.py")

#: when set (``--fast``), only these rel-paths seed the analysis
_SCOPE: set[str] | None = None


def scope_to(paths: set[str] | None) -> None:
    """Restrict taint entry points (``--fast`` changed-file SCC mode)."""
    global _SCOPE
    _SCOPE = set(paths) if paths is not None else None


def registry_policy(root: str) -> Policy:
    """Derive the taint policy from ``agg/registry.py``'s AST (never
    imported), mirroring ``Aggregator.supports_masked_delivery``."""
    sanitizers = {"tree_agg"}
    weight_fns = {"selection_weights"}
    robust: dict[str, bool] = {}
    all_rules: set[str] = set()
    path = os.path.join(root, _AGG_REGISTRY)
    if os.path.exists(path):
        with open(path) as f:
            tree = ast.parse(f.read(), filename=_AGG_REGISTRY)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "register"):
                continue
            for arg in node.args:
                if not (isinstance(arg, ast.Call)
                        and isinstance(arg.func, ast.Name)
                        and arg.func.id == "Aggregator"):
                    continue
                kw = {k.arg: k.value for k in arg.keywords if k.arg}
                try:
                    name = ast.literal_eval(kw["name"])
                    requires = tuple(ast.literal_eval(kw["requires"]))
                except Exception:
                    continue
                all_rules.add(name)
                masked_ok = "masked_fn" in kw or (
                    "selection_based" in kw
                    and "weights_from_d2" in kw)
                if requires[0] < 2:
                    continue            # mean: no breakdown point
                robust[name] = masked_ok
                sanitizers.add(name)
                for field, dest in (("masked_fn", sanitizers),
                                    ("weights_from_d2", weight_fns)):
                    if field in kw:
                        ref = ast.unparse(kw[field]).split(".")[-1]
                        dest.add(ref)
    return Policy(
        sources=frozenset({"inject_gradients", "inject_models", "corrupt"}),
        sanitizers=frozenset(sanitizers),
        weight_fns=frozenset(weight_fns),
        robust_rules=robust,
        all_rules=frozenset(all_rules),
        sink_ctors=frozenset({"SimState", "ByzState"}),
        sink_kwargs=frozenset({"params", "w_model"}),
        sink_calls=frozenset({"save"}),
    )


def taint_modules(root: str) -> dict[str, ast.Module]:
    """Parse the modules the taint engine reasons over
    (``src/repro_torch``)."""
    from ..astlint import lint_paths
    modules: dict[str, ast.Module] = {}
    prefix = os.path.join("src", "repro_torch") + os.sep
    for path in lint_paths(root):
        rel = os.path.relpath(path, root)
        if not rel.startswith(prefix):
            continue
        try:
            with open(path) as f:
                modules[rel] = ast.parse(f.read(), filename=rel)
        except SyntaxError:
            continue                    # REPRO-PARSE reports it
    return modules


def scc_closure(modules: dict[str, ast.Module],
                changed: set[str]) -> set[str]:
    """Changed files plus their file-level call-graph component.

    Edges: file A — file B when A calls a name defined top-level in B
    (taken undirected, so callers of a changed file are re-checked too —
    a conservative superset of the strongly-connected component). The
    returned scope seeds ``make lint-fast``'s taint entry points.
    """
    defs: dict[str, str] = {}
    for path, tree in modules.items():
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(node.name, path)
    edges: dict[str, set[str]] = {p: set() for p in modules}
    for path, tree in modules.items():
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                fn = node.func
                name = fn.attr if isinstance(fn, ast.Attribute) else \
                    fn.id if isinstance(fn, ast.Name) else None
                tgt = defs.get(name or "")
                if tgt and tgt != path:
                    edges[path].add(tgt)
                    edges[tgt].add(path)    # undirected: callers re-check
    out: set[str] = set()
    stack = [p for p in changed if p in edges]
    while stack:
        p = stack.pop()
        if p in out:
            continue
        out.add(p)
        stack.extend(edges.get(p, ()))
    return out or set(changed)


def check(root: str) -> list[Finding]:
    modules = taint_modules(root)
    policy = registry_policy(root)
    engine = TaintEngine(modules, policy)
    entry = None
    if _SCOPE is not None:
        entry = scc_closure(modules, {p for p in _SCOPE if p in modules})
    found = []
    for hit in engine.run(entry_paths=entry):
        found.append(Finding(
            "REPRO-TAINT-BYZ", hit.path, hit.line,
            f"Byzantine-tainted value reaches {hit.sink} without a "
            f"registered robust GAR on the path; witness: {hit.witness()}",
            "launder through a robust `repro_torch.agg` rule (or its "
            "masked_fn/weights_from_d2) before writing model state; if the "
            "guard is a deliberate non-GAR mechanism, suppress inline with "
            "the paper reference"))
    return found


register(Rule(
    rule_id="REPRO-TAINT-BYZ",
    scope="repo",
    description="interprocedural taint: every cross-node ingress "
                "(inject_*/corrupt) is laundered by a robust registry GAR "
                "before reaching params/w_model/checkpoint sinks; witness "
                "path printed per violation",
    check=check,
    fix_hint="insert the GAR, or suppress with the paper mechanism cited",
))

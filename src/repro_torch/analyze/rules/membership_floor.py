"""REPRO-MEMBERSHIP-FLOOR: membership shrinks must be floor-guarded.

Elastic membership (``core/membership.py``) and quorum serving
(``serve/replica.py``) both carry a notion of an *active* set that may
shrink at runtime — and every shrink must be checked against a resilience
floor (Table 1's ``n >= 3f+1`` / ``3f+2`` for training epochs, the
``2f+1`` read quorum for serving) before it takes effect. A shrink that
skips the check wedges the fleet silently: quorums become unsatisfiable
and every later aggregation under-collects without an error.

Two static checks, neither importing the checked code:

* **mask shrinks** (per file): an assignment of ``False`` into a
  subscript of an ``active``-named mask (``self.active[i] = False``,
  ``pool.active[i] = False``) or an in-place intersection
  (``active &= mask``) must sit in a function that shows floor-guard
  evidence — a name/attribute mentioning ``floor``, a call to a
  ``validate``/``epoch_config``-style checker, or an explicit
  ``2*f + c`` quorum-bound computation.
* **symbolic plans** (per file): every ``Experiment(...)`` call whose
  ``membership_plan`` is a literal ``MembershipPlan(events=...)`` (direct
  kwargs or ``**_COMMON`` dict expansion, same resolution as
  REPRO-BYZ-BOUNDS) is simulated: the realized active set must never
  shrink below 2 groups, and the churn-driven caps
  (``f_w' = (G'-1)//3``, ``f_ps' = (G'-2)//3`` — the quorum window
  binds before sync's cheaper worker bound) must still cover the
  declared-present Byzantine counts at every epoch. Calls whose shape or
  plan is not statically resolvable are skipped — the runtime validator
  (``membership.epoch_config``) still owns those.
"""
from __future__ import annotations

import ast

from ..astlint import dotted_name
from ..findings import Finding
from ..registry import Rule, register
from .preconditions import _module_dicts

#: substrings that mark a call as floor-checking within the enclosing fn
_GUARD_CALLS = ("floor", "validate", "epoch_config")


# ---------------------------------------------------------------------------
# part A: unguarded active-mask shrinks
# ---------------------------------------------------------------------------


def _mask_name(node: ast.AST) -> str:
    """The terminal name of a mask target: ``self.pool.active`` ->
    'active'; '' when the expression has no name tail."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _is_shrink(stmt: ast.AST):
    """(lineno, spelled-target) when ``stmt`` shrinks an active mask."""
    if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Subscript)
            and isinstance(stmt.value, ast.Constant)
            and stmt.value.value is False
            and "active" in _mask_name(stmt.targets[0].value)):
        return stmt.lineno, ast.unparse(stmt.targets[0])
    if (isinstance(stmt, ast.AugAssign) and isinstance(stmt.op, ast.BitAnd)):
        target = stmt.target
        base = target.value if isinstance(target, ast.Subscript) else target
        if "active" in _mask_name(base):
            return stmt.lineno, ast.unparse(target)
    return None


def _is_quorum_bound(node: ast.AST) -> bool:
    """``2 * f + c`` — the explicit quorum-floor arithmetic."""
    if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add)):
        return False
    terms = (node.left, node.right)
    has_mult = any(
        isinstance(t, ast.BinOp) and isinstance(t.op, ast.Mult)
        and any(isinstance(s, ast.Constant) and s.value in (2, 3)
                for s in (t.left, t.right))
        for t in terms)
    has_const = any(isinstance(t, ast.Constant) and isinstance(t.value, int)
                    for t in terms)
    return has_mult and has_const


def _guarded(fn: ast.AST) -> bool:
    """Floor-guard evidence anywhere in the enclosing function."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute) and "floor" in node.attr:
            return True
        if isinstance(node, ast.Name) and "floor" in node.id:
            return True
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if any(g in name for g in _GUARD_CALLS):
                return True
        if _is_quorum_bound(node):
            return True
    return False


def _shrink_findings(tree: ast.AST, path: str) -> list[Finding]:
    owner: dict[ast.AST, ast.AST] = {}
    for fn in [n for n in ast.walk(tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
        for node in ast.walk(fn):
            owner[node] = fn        # breadth-first: innermost fn wins
    found = []
    for node in ast.walk(tree):
        hit = _is_shrink(node)
        if hit is None:
            continue
        lineno, target = hit
        fn = owner.get(node)
        if fn is not None and _guarded(fn):
            continue
        found.append(Finding(
            "REPRO-MEMBERSHIP-FLOOR", path, lineno,
            f"active-mask shrink `{target}` without a resilience-floor "
            f"guard in the enclosing function",
            "check the post-shrink count against the quorum floor first "
            "(2f+1 reads / Table-1 training bounds; see "
            "ReplicaPool.deactivate, membership.epoch_config)"))
    return found


# ---------------------------------------------------------------------------
# part B: symbolic membership plans on Experiment(...) calls
# ---------------------------------------------------------------------------


def _called(node: ast.AST, name: str) -> bool:
    return (isinstance(node, ast.Call)
            and dotted_name(node.func).split(".")[-1] == name)


def _event_tuple(node: ast.AST):
    """One literal event -> (step, kind, group), else None."""
    if _called(node, "MembershipEvent"):
        kw = {k.arg: k.value for k in node.keywords if k.arg}
        try:
            return (ast.literal_eval(kw["step"]),
                    ast.literal_eval(kw["kind"]),
                    ast.literal_eval(kw["group"]))
        except Exception:
            return None
    try:
        d = ast.literal_eval(node)
        return (d["step"], d["kind"], d["group"])
    except Exception:
        return None


def _plan_events(node: ast.AST):
    """Literal ``MembershipPlan(events=(...))`` -> [(step, kind, group)]
    sorted by step, or None when not statically resolvable."""
    if not _called(node, "MembershipPlan"):
        return None
    ev_node = None
    for k in node.keywords:
        if k.arg == "events":
            ev_node = k.value
    if ev_node is None and node.args:
        ev_node = node.args[0]
    if ev_node is None:
        return []                    # MembershipPlan() — empty plan
    if not isinstance(ev_node, (ast.Tuple, ast.List)):
        return None
    events = []
    for el in ev_node.elts:
        ev = _event_tuple(el)
        if ev is None:
            return None
        events.append(ev)
    return sorted(events)


def _byz_counts(node: ast.AST) -> tuple[int, int] | None:
    """Literal ``ByzantineSpec(...)`` -> (n_byz_workers, n_byz_servers)."""
    if not _called(node, "ByzantineSpec"):
        return None
    out = {"n_byz_workers": 0, "n_byz_servers": 0}
    for k in node.keywords:
        if k.arg in out:
            try:
                out[k.arg] = ast.literal_eval(k.value)
            except Exception:
                return None
    return out["n_byz_workers"], out["n_byz_servers"]


def _plan_findings(tree: ast.AST, path: str) -> list[Finding]:
    dicts = _module_dicts(tree) if isinstance(tree, ast.Module) else {}
    found = []
    for node in ast.walk(tree):
        if not _called(node, "Experiment"):
            continue
        fields: dict = {}
        plan = name = byz = None
        for kw in node.keywords:
            if kw.arg is None:       # **_COMMON expansion
                fields.update(dicts.get(getattr(kw.value, "id", ""), {}))
                continue
            if kw.arg == "membership_plan":
                plan = _plan_events(kw.value)
            elif kw.arg == "byz":
                byz = _byz_counts(kw.value)
            elif kw.arg == "name":
                try:
                    name = ast.literal_eval(kw.value)
                except Exception:
                    pass
            else:
                try:
                    fields[kw.arg] = ast.literal_eval(kw.value)
                except Exception:
                    pass
        n_groups = fields.get("n_workers")
        if plan is None or not isinstance(n_groups, int):
            continue                 # no plan, or not statically resolvable
        f_w = fields.get("f_workers", 0)
        f_ps = fields.get("f_servers", 0)
        bw, bs = byz if byz is not None else (0, 0)
        label = name or f"<Experiment@{node.lineno}>"
        active = set(range(n_groups))
        for step, kind, group in plan:
            active.discard(group) if kind == "leave" else active.add(group)
            Gp = len(active)
            if Gp < 2:
                found.append(Finding(
                    "REPRO-MEMBERSHIP-FLOOR", path, node.lineno,
                    f"`{label}`: membership plan shrinks the fleet to "
                    f"G'={Gp} at step {step} — below the 2-group protocol "
                    "floor",
                    "keep >= 2 groups active, or drop the leave event"))
                break
            fw_cap = (Gp - 1) // 3
            fps_cap = max((Gp - 2) // 3, 0)
            if bw > min(f_w, fw_cap) or bs > min(f_ps, fps_cap):
                found.append(Finding(
                    "REPRO-MEMBERSHIP-FLOOR", path, node.lineno,
                    f"`{label}`: at step {step} the shrunk fleet (G'={Gp}) "
                    f"caps tolerable faults at f_w'={min(f_w, fw_cap)}, "
                    f"f_ps'={min(f_ps, fps_cap)}, below the declared-present "
                    f"Byzantine counts ({bw} workers, {bs} servers)",
                    "shrink less, or declare fewer Byzantine nodes for the "
                    "elastic run (membership.epoch_config rejects this at "
                    "runtime too)"))
                break
    return found


def check(tree: ast.AST, source: str, path: str) -> list[Finding]:
    return _shrink_findings(tree, path) + _plan_findings(tree, path)


register(Rule(
    rule_id="REPRO-MEMBERSHIP-FLOOR",
    scope="file",
    description="active-set shrinks are resilience-floor-guarded; literal "
                "`membership_plan`s never shrink below 2 groups or under "
                "the declared Byzantine counts (symbolic, like "
                "REPRO-BYZ-BOUNDS)",
    check=check,
    fix_hint="guard the shrink with the quorum floor / fix the plan",
))

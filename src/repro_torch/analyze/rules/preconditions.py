"""REPRO-BYZ-BOUNDS: Byzantine resilience preconditions on every preset.

The paper's Table-1 bounds, checked *symbolically* over
``exp/presets.py`` — every ``register(Experiment(...))`` call is
evaluated from the AST (literal kwargs, ``**_COMMON`` dict expansion,
dataclass defaults from ``exp/spec.py``) without importing the module:

* async: ``n_w >= 3 f_w + 1``;   sync: ``n_w >= 2 f_w + 1``
* servers: ``n_ps >= 3 f_ps + 2``  (Table 1's correct-majority quorum
  bound — one stronger than the naive ``3 f + 1`` replication bound)
* quorums: ``2 f_w + 1 <= q_w <= n_w - f_w`` and
  ``2 f_ps + 2 <= q_ps <= n_ps - f_ps`` (defaults as derived by
  ``ByzSGDConfig``)
* the DMC/serve read bound ``R >= 2 f + 1`` on the server replicas.

Runtime validation (``core/quorum.validate_counts``) already rejects bad
configs when they *run*; this rule rejects them when they're *written*,
and — because it re-derives the bounds instead of importing the
validator — it also catches the validator itself being edited out of
agreement with the presets.
"""
from __future__ import annotations

import ast
import os

from ..astlint import literal_str
from ..findings import Finding
from ..registry import Rule, register

_SPEC = os.path.join("src", "repro_torch", "exp", "spec.py")
_PRESETS = os.path.join("src", "repro_torch", "exp", "presets.py")
_FIELDS = ("n_workers", "f_workers", "n_servers", "f_servers",
           "q_workers", "q_servers", "variant")


def _experiment_defaults(root: str) -> dict:
    """Field defaults of the Experiment dataclass, read from spec.py's AST."""
    with open(os.path.join(root, _SPEC)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "Experiment":
            out = {}
            for stmt in node.body:
                if (isinstance(stmt, ast.AnnAssign) and stmt.value is not None
                        and isinstance(stmt.target, ast.Name)):
                    try:
                        out[stmt.target.id] = ast.literal_eval(stmt.value)
                    except Exception:
                        pass
            return out
    raise LookupError("Experiment dataclass not found in exp/spec.py")


def _module_dicts(tree: ast.Module) -> dict[str, dict]:
    """Module-level ``NAME = dict(k=v, ...)`` / ``NAME = {...}`` literals
    (the ``**_NETSIM_COMMON`` expansion sources)."""
    out: dict[str, dict] = {}
    for stmt in tree.body:
        if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)):
            continue
        val = stmt.value
        d: dict | None = None
        if isinstance(val, ast.Call) and isinstance(val.func, ast.Name) \
                and val.func.id == "dict" and not val.args:
            d = {}
            for kw in val.keywords:
                if kw.arg is None:
                    d = None
                    break
                try:
                    d[kw.arg] = ast.literal_eval(kw.value)
                except Exception:
                    d[kw.arg] = None  # non-literal: not bounds-relevant
        elif isinstance(val, ast.Dict):
            try:
                d = ast.literal_eval(val)
            except Exception:
                d = None
        if d is not None:
            out[stmt.targets[0].id] = d
    return out


def _preset_calls(tree: ast.Module):
    """(Experiment-call, lineno) under every ``register(...)`` call."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "register"):
            for arg in node.args:
                if (isinstance(arg, ast.Call)
                        and isinstance(arg.func, ast.Name)
                        and arg.func.id == "Experiment"):
                    yield arg, node.lineno


def _resolve_fields(call: ast.Call, defaults: dict, dicts: dict) -> dict:
    fields = {k: defaults.get(k) for k in _FIELDS}
    fields["name"] = None
    for kw in call.keywords:
        if kw.arg is None:  # **_COMMON expansion
            src = dicts.get(getattr(kw.value, "id", ""), {})
            for k in _FIELDS:
                if k in src:
                    fields[k] = src[k]
            if "name" in src:
                fields["name"] = src["name"]
            continue
        if kw.arg == "name":
            fields["name"] = literal_str(kw.value)
        elif kw.arg in _FIELDS:
            try:
                fields[kw.arg] = ast.literal_eval(kw.value)
            except Exception:
                pass  # non-literal (runtime value): leave the default
    return fields


def _bounds_violations(f: dict) -> list[str]:
    n_w, f_w = f["n_workers"], f["f_workers"]
    n_ps, f_ps = f["n_servers"], f["f_servers"]
    sync = f.get("variant") == "sync"
    q_w = f["q_workers"] or (n_w - f_w)
    q_ps = f["q_servers"] or max(n_ps - f_ps, 2 * f_ps + 2)
    probs = []
    if sync:
        if n_w < 2 * f_w + 1:
            probs.append(f"sync needs n_w >= 2f_w+1 ({n_w} < {2*f_w+1})")
    elif n_w < 3 * f_w + 1:
        probs.append(f"async needs n_w >= 3f_w+1 ({n_w} < {3*f_w+1})")
    if n_ps < 3 * f_ps + 2:
        probs.append(f"needs n_ps >= 3f_ps+2 ({n_ps} < {3*f_ps+2})")
    if not (2 * f_w + 1 <= q_w <= n_w - f_w):
        probs.append(f"needs 2f_w+1 <= q_w <= n_w-f_w (q_w={q_w})")
    if not (2 * f_ps + 2 <= q_ps <= n_ps - f_ps):
        probs.append(f"needs 2f_ps+2 <= q_ps <= n_ps-f_ps (q_ps={q_ps})")
    if n_ps < 2 * f_ps + 1:  # the R >= 2f+1 replicated-read bound
        probs.append(f"needs R >= 2f+1 server replicas ({n_ps} < {2*f_ps+1})")
    return probs


def check(root: str) -> list[Finding]:
    path = os.path.join(root, _PRESETS)
    if not os.path.exists(path):
        return [Finding("REPRO-BYZ-BOUNDS", _PRESETS, 0,
                        "exp/presets.py not found")]
    with open(path) as f:
        tree = ast.parse(f.read(), filename=_PRESETS)
    defaults = _experiment_defaults(root)
    dicts = _module_dicts(tree)
    found = []
    n_checked = 0
    for call, lineno in _preset_calls(tree):
        fields = _resolve_fields(call, defaults, dicts)
        n_checked += 1
        name = fields["name"] or f"<preset@{lineno}>"
        for prob in _bounds_violations(fields):
            found.append(Finding(
                "REPRO-BYZ-BOUNDS", _PRESETS, lineno,
                f"preset `{name}`: {prob}",
                "adjust the cluster shape; see core/quorum.validate_counts "
                "(Table 1)"))
    if n_checked == 0:
        found.append(Finding(
            "REPRO-BYZ-BOUNDS", _PRESETS, 0,
            "no register(Experiment(...)) calls found — preset structure "
            "changed under the rule",
            "update analyze/rules/preconditions.py to the new structure"))
    return found


register(Rule(
    rule_id="REPRO-BYZ-BOUNDS",
    scope="repo",
    description="Table-1 resilience bounds (`n_w>=3f_w+1` async / "
                "`2f_w+1` sync, `n_ps>=3f_ps+2`, quorum windows, "
                "`R>=2f+1`) hold symbolically for every preset",
    check=check,
    fix_hint="fix the preset's cluster shape",
))

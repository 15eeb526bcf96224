"""REPRO-DETERMINISM: bit-identical-resume hazards.

The port's elastic membership and checkpoints promise bit-identical
resume: replaying the same event log over the same seed must reproduce
the same parameters, on every rank. Three hazard classes break that
silently — no functional test fails, results just stop being
reproducible:

* **unordered iteration** — a ``for``/comprehension/reduction driven by a
  ``set`` (literal or ``set(...)`` call) iterates in hash order, which
  varies across processes (``PYTHONHASHSEED``; a ``torch.dtype`` hashes by
  object identity) — if that order feeds collective order, cache keys or
  manifests, ranks and resumes diverge. Wrap in ``sorted(...)``.
* **unsorted hash payloads** — ``json.dumps`` without ``sort_keys=True``
  feeding a digest (``hashlib.*``/``hash``) keys the cache on dict
  insertion order.
* **the global generator** — a ``torch.rand``/``randn``/``randint``/
  ``randperm``/``normal``/``bernoulli``/``multinomial`` call without
  ``generator=`` draws from torch's process-global generator, which any
  other draw in the process advances. The port threads an explicit
  ``torch.Generator`` everywhere (the reference threads a PRNG key).
"""
from __future__ import annotations

import ast

from ..astlint import dotted_name
from ..findings import Finding
from ..registry import Rule, register

_HASH_FNS = {"md5", "sha1", "sha256", "sha512", "blake2b", "blake2s",
             "hash", "update"}
_REDUCERS = {"sum", "min", "max", "reduce", "prod"}
_GLOBAL_DRAWS = {"torch.rand", "torch.randn", "torch.randint",
                 "torch.randperm", "torch.normal", "torch.bernoulli",
                 "torch.multinomial"}


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else \
            fn.attr if isinstance(fn, ast.Attribute) else ""
        if name in ("set", "frozenset"):
            return True
        # dict-view difference/union etc. still ordered; skip
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.BitAnd, ast.BitOr, ast.Sub, ast.BitXor)):
        # set algebra: a & b, a | b, a - b on sets — only flag when one
        # side is provably a set expression
        return _is_set_expr(node.left) or _is_set_expr(node.right)
    return False


def _iter_sites(tree: ast.AST):
    """Yield (iter_expr, lineno, context) for every iteration site."""
    for node in ast.walk(tree):
        if isinstance(node, ast.For):
            yield node.iter, node.lineno, "for loop"
        elif isinstance(node, (ast.ListComp, ast.GeneratorExp,
                               ast.DictComp)):
            for gen in node.generators:
                yield gen.iter, node.lineno, "comprehension"
        elif isinstance(node, ast.Call):
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else \
                fn.attr if isinstance(fn, ast.Attribute) else ""
            if name in _REDUCERS and node.args:
                yield node.args[0], node.lineno, f"{name}() reduction"
            elif name == "list" and node.args:
                yield node.args[0], node.lineno, "list() materialization"


def _json_dumps_feeding_hash(tree: ast.AST):
    """Yield unsorted json.dumps calls that reach a digest function."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else \
            fn.id if isinstance(fn, ast.Name) else ""
        if name not in _HASH_FNS:
            continue
        for a in node.args:
            for arg in ast.walk(a):
                if (isinstance(arg, ast.Call)
                        and dotted_name(arg.func) in ("json.dumps", "dumps")):
                    kw = {k.arg for k in arg.keywords}
                    if "sort_keys" not in kw:
                        yield arg.lineno


def _global_draws(tree: ast.AST):
    """(name, line) of every random draw without ``generator=``."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        if name in _GLOBAL_DRAWS and not any(
                k.arg == "generator" for k in node.keywords):
            yield name, node.lineno


def check(tree: ast.AST, source: str, path: str) -> list[Finding]:
    found: list[Finding] = []
    for it, line, ctx in _iter_sites(tree):
        if _is_set_expr(it):
            found.append(Finding(
                "REPRO-DETERMINISM", path, line,
                f"{ctx} iterates a set in hash order — feeding trace "
                "order, cache keys, or manifests from it breaks "
                "bit-identical resume",
                "wrap the iterable in sorted(...)"))
    for line in _json_dumps_feeding_hash(tree):
        found.append(Finding(
            "REPRO-DETERMINISM", path, line,
            "json.dumps without sort_keys=True feeds a digest — the key "
            "depends on dict insertion order",
            "pass sort_keys=True to json.dumps"))
    for name, line in _global_draws(tree):
        found.append(Finding(
            "REPRO-DETERMINISM", path, line,
            f"`{name}` without `generator=` draws from the process-global "
            "generator — any other draw moves it",
            "pass the run's torch.Generator (generator=gen)"))
    return found


register(Rule(
    rule_id="REPRO-DETERMINISM",
    scope="file",
    description="no set-order iteration feeding collectives/keys/"
                "manifests, no unsorted json.dumps into digests, every "
                "`torch.rand*`/`normal`/`bernoulli`/`multinomial`/"
                "`randperm` draw passes `generator=`",
    check=check,
    fix_hint="sorted(...) the iterable / sort_keys=True / generator=gen",
))

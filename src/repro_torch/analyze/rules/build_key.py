"""REPRO-BUILD-KEY: the kernels' build cache is keyed by all it builds from.

The port has no compiled-epoch cache (``core/epochs.py`` is not ported), so
the reference's REPRO-CACHE-KEY has nothing to check. Its one cache keyed
by content is the kernels' build: ``kernels/_build.py`` names each library
by a hash of ``NVCC_FLAGS`` and of every file in its source's ``csrc/``
directory, and reuses a library whose name exists. That key is sound only
while three things hold, each checked here from the text and
``_build.py``'s AST (nothing is imported or compiled):

* every ``#include "..."`` in a CUDA source resolves inside the ``csrc/``
  directory that is hashed — a header included from elsewhere could
  change without a rebuild;
* every ``.cu`` under ``kernels/`` is in ``SOURCES`` — one that is not is
  never built, so its kernel is never run;
* ``NVCC_FLAGS`` name ``sm_90a`` — the kernels' ``wgmma``/TMA need the
  ``a`` target, and a library built for another is reused as if it were.
"""
from __future__ import annotations

import ast
import os

from ..findings import Finding
from ..registry import Rule, register
from .cuda_audit import KERNELS_DIR, sources

BUILD = os.path.join(KERNELS_DIR, "_build.py")
_HINT = "keep each kernel's sources and headers in its csrc/ and in SOURCES"


def _finding(path: str, line: int, msg: str) -> Finding:
    return Finding("REPRO-BUILD-KEY", path, line, msg, _HINT)


def _path_parts(node: ast.AST) -> list[str] | None:
    """``_HERE / "a" / "csrc" / "x.cu"`` -> ["a", "csrc", "x.cu"]."""
    parts: list[str] = []
    while isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
        if not (isinstance(node.right, ast.Constant)
                and isinstance(node.right.value, str)):
            return None
        parts.append(node.right.value)
        node = node.left
    return list(reversed(parts)) if isinstance(node, ast.Name) else None


def _build_module(root: str):
    """(``SOURCES`` rel paths -> line, ``NVCC_FLAGS`` strings and line)."""
    with open(os.path.join(root, BUILD)) as f:
        tree = ast.parse(f.read(), filename=BUILD)
    srcs: dict[str, int] = {}
    flags, flags_line = None, 0
    for stmt in tree.body:
        if not (isinstance(stmt, (ast.Assign, ast.AnnAssign))):
            continue
        target = stmt.targets[0] if isinstance(stmt, ast.Assign) \
            else stmt.target
        name = getattr(target, "id", "")
        if name == "SOURCES" and isinstance(stmt.value, ast.Dict):
            for v in stmt.value.values:
                parts = _path_parts(v)
                if parts:
                    srcs[os.path.join(KERNELS_DIR, *parts)] = v.lineno
        elif name == "NVCC_FLAGS":
            flags_line = stmt.lineno
            try:
                flags = [str(x) for x in ast.literal_eval(stmt.value)]
            except ValueError:
                flags = None
    return srcs, flags, flags_line


def check(root: str) -> list[Finding]:
    if not os.path.exists(os.path.join(root, BUILD)):
        return [_finding(BUILD, 0, "kernels/_build.py not found")]
    srcs, flags, flags_line = _build_module(root)
    found: list[Finding] = []
    all_src = sources(root)
    for src in all_src:
        csrc = os.path.dirname(src.rel)
        for line, name in src.includes():
            dep = os.path.normpath(os.path.join(csrc, name))
            if (os.path.dirname(dep) != csrc
                    or not os.path.exists(os.path.join(root, dep))):
                found.append(_finding(
                    src.rel, line,
                    f'`#include "{name}"` does not resolve inside {csrc}, '
                    "the directory the build hashes: an edit to it would "
                    "not rebuild the library"))
    cus = {s.rel for s in all_src if s.rel.endswith(".cu")}
    for rel in sorted(cus - set(srcs)):
        found.append(_finding(rel, 0, "CUDA source not in _build.SOURCES: "
                                      "it is never built"))
    for rel, line in sorted(srcs.items()):
        if rel not in cus:
            found.append(_finding(BUILD, line,
                                  f"SOURCES names {rel}, which is not a "
                                  "CUDA source under kernels/*/csrc/"))
    if flags is None or not any("sm_90a" in f for f in flags):
        found.append(_finding(BUILD, flags_line,
                              "NVCC_FLAGS do not name sm_90a (the kernels' "
                              "wgmma and TMA need it)"))
    return found


register(Rule(
    rule_id="REPRO-BUILD-KEY",
    scope="repo",
    description="the kernels' build key covers what they build from: "
                "every local `#include` resolves in the hashed `csrc/`, "
                "every `.cu` is in `_build.SOURCES`, `NVCC_FLAGS` name "
                "`sm_90a`",
    check=check,
    fix_hint=_HINT,
))

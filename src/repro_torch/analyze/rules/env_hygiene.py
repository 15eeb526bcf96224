"""REPRO-ENV: the port reads no environment switch.

The reference keeps its backend and sort-network switches in ``REPRO_*``
environment flags and two rules police them (REPRO-ENV-IMPORT,
REPRO-ENV-MUTATE). The port has no environment switch at all (ROADMAP,
North star): every option is an argument. So the port's rule is
stricter — anywhere under the lint roots:

* no ``REPRO_*`` read or write, at import time or at call time;
* no write, ``pop``, ``setdefault``, ``update`` or ``del`` of any
  ``os.environ`` key;
* no read of a key outside :data:`ALLOWED`: the variables ``torchrun``
  sets for a rank (``launch/mesh.py``) and ``CUDA_HOME``, where the kernel
  build looks for ``nvcc`` (``kernels/_build.py``). A read whose key is
  not a literal is flagged too.

``os.environ`` reached through a local alias (``env = os.environ``) counts
the same.
"""
from __future__ import annotations

import ast

from ..astlint import dotted_name, literal_str
from ..findings import Finding
from ..registry import Rule, register

_PREFIX = "REPRO_"
#: the environment reads the port makes, and why
ALLOWED = {
    "WORLD_SIZE": "torchrun: the run's ranks (launch/mesh.py)",
    "RANK": "torchrun: this rank (launch/mesh.py)",
    "LOCAL_RANK": "torchrun: this rank on its host (launch/mesh.py)",
    "LOCAL_WORLD_SIZE": "torchrun: the ranks on this host",
    "MASTER_ADDR": "torchrun: the rendezvous (env://)",
    "MASTER_PORT": "torchrun: the rendezvous (env://)",
    "CUDA_HOME": "the CUDA toolkit nvcc is looked for in "
                 "(kernels/_build.py)",
}
_ENVIRON = {"os.environ", "environ"}
_READS = {"get"}
_WRITES = {"pop", "setdefault", "update", "clear", "popitem"}
_GETENV = {"os.getenv", "getenv"}
_PUTENV = {"os.putenv", "putenv", "os.unsetenv", "unsetenv"}


def _aliases(tree: ast.AST) -> set[str]:
    """Names bound to ``os.environ`` (``env = os.environ``)."""
    out = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and dotted_name(node.value) in _ENVIRON):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return out


def _finding(path: str, line: int, what: str) -> Finding:
    return Finding(
        "REPRO-ENV", path, line, what,
        "pass the option as an argument (the port has no environment "
        "switch); a new torchrun variable goes into ALLOWED with its reason")


def _read(path: str, line: int, key: str | None) -> list[Finding]:
    if key is None:
        return [_finding(path, line, "environment read of a key that is "
                                     "not a literal")]
    if key.startswith(_PREFIX):
        return [_finding(path, line, f"{key} read: the port has no "
                                     "REPRO_* switch")]
    if key not in ALLOWED:
        return [_finding(path, line, f"environment read of {key!r}, "
                                     "which is not in the rule's "
                                     "allow-list")]
    return []


def check(tree: ast.AST, source: str, path: str) -> list[Finding]:
    env = _ENVIRON | _aliases(tree)
    found: list[Finding] = []
    written: set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
            targets = (node.targets if isinstance(node, (ast.Assign,
                                                         ast.Delete))
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Subscript) and \
                        dotted_name(t.value) in env:
                    written.add(id(t))
                    key = literal_str(t.slice)
                    found.append(_finding(
                        path, node.lineno,
                        f"write of os.environ[{key!r}]" if key else
                        "write of an os.environ key"))
        elif isinstance(node, ast.Call):
            name = dotted_name(node.func)
            head, _, attr = name.rpartition(".")
            key = literal_str(node.args[0]) if node.args else None
            if name in _GETENV or (head in env and attr in _READS):
                found.extend(_read(path, node.lineno, key))
            elif name in _PUTENV or (head in env and attr in _WRITES):
                found.append(_finding(
                    path, node.lineno,
                    f"`{attr or name}` on the environment"
                    + (f" ({key!r})" if key else "")))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Subscript) and id(node) not in written
                and dotted_name(node.value) in env):
            found.extend(_read(path, node.lineno, literal_str(node.slice)))
    return found


register(Rule(
    rule_id="REPRO-ENV",
    scope="file",
    description="no `REPRO_*` read or write, no environment write, and "
                "no read outside torchrun's rank variables and "
                "`CUDA_HOME` (the port has no environment switch)",
    check=check,
    fix_hint="make the option an argument",
))

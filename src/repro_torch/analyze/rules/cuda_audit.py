"""REPRO-CUDA-*: static audit of the port's CUDA sources.

Every ``.cu`` and ``.cuh`` under ``src/repro_torch/kernels/*/csrc/`` is
read as text with its comments and string literals blanked (newlines
kept, so line numbers hold) and never compiled. A ``.cu`` is audited
together with the local headers it includes (``#include "..."``), as
``nvcc`` sees it. Four rules mirror the reference's four Pallas rules
(``rules/pallas_audit.py`` of ``repro.analyze``):

* **REPRO-CUDA-GRID** (cf. REPRO-PALLAS-GRID) — every grid dimension made
  by a division (the first ``<<<...>>>`` argument, the ``dim3``/integer it
  names, and the body of a ``dim3``-returning helper it calls) uses the
  ceil-div idiom ``(X + B - 1) / B`` (or ``(X + 63) / 64``), or the same
  source holds divisibility evidence ``X % B`` (e.g. ``d % 2 != 0`` ->
  ``cudaErrorInvalidValue`` licenses ``d / 2``). Otherwise a ragged
  trailing tile is silently dropped.
* **REPRO-CUDA-GUARD** (cf. REPRO-PALLAS-OOB) — a ``__global__`` kernel
  launched on a ceil-div grid compares an index it derives from
  ``blockIdx`` with a size parameter before its first global access
  (``if (col >= d) return;``, ``nwg = q0 + 64 < Sq ? 2 : 1``), or hands
  both to the helper that makes that access (``load_tile(.., q0, Sq,
  ..)``). The ceil-div grid's last block runs past the data.
* **REPRO-CUDA-ACC** (cf. REPRO-PALLAS-ACC) — no ``+=`` into a
  ``__nv_bfloat16``/``__half`` variable, array or pointer (a narrow
  accumulator loses low bits every step), and every ``wgmma.mma_async``
  instruction accumulates in ``f32`` (its string is read for that).
* **REPRO-CUDA-MASK** (cf. REPRO-PALLAS-MASK) — a kernel that runs a
  sorting network (a call whose name holds ``sort``/``bitonic``/
  ``compare_exchange``) maps NaN to the finite ``BIG`` sentinel before its
  first compare-exchange — in its body or in a helper it calls first —
  as ``cwise_median.cu``'s loads do: NaN poisons ``fminf``/``fmaxf``
  networks.
"""
from __future__ import annotations

import os
import re

from ..findings import Finding
from ..registry import Rule, register

KERNELS_DIR = os.path.join("src", "repro_torch", "kernels")
_SUFFIXES = (".cu", ".cuh")
_NARROW = ("__nv_bfloat16", "__half", "__nv_bfloat162", "__half2",
           "nv_bfloat16", "half")
_INT_TYPES = r"(?:const\s+)?(?:unsigned\s+|signed\s+)?(?:int|long\s+long|" \
             r"long|size_t|int64_t|int32_t|uint32_t|unsigned)"
_SORT_CALL = re.compile(r"\b(\w*(?:sort|bitonic|compare_exchange)\w*)\s*"
                        r"(?:<[^;(){}]*>)?\s*\(")


# ---------------------------------------------------------------------------
# reading a source
# ---------------------------------------------------------------------------


def strip(text: str) -> tuple[str, list[tuple[int, str]]]:
    """(``text`` with comments and string/char literals blanked to spaces,
    newlines kept; the string literals as ``(line, body)``)."""
    out = list(text)
    strings: list[tuple[int, str]] = []
    i, n, line = 0, len(text), 1
    while i < n:
        c = text[i]
        if c == "\n":
            line += 1
            i += 1
        elif text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            for k in range(i, j):
                out[k] = " "
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            for k in range(i, j):
                if text[k] != "\n":
                    out[k] = " "
            line += text.count("\n", i, j)
            i = j
        elif c in "\"'":
            j = i + 1
            while j < n and text[j] != c and text[j] != "\n":
                j += 2 if text[j] == "\\" else 1
            if c == '"':
                strings.append((line, text[i + 1:j]))
            for k in range(i, min(j + 1, n)):
                out[k] = " "
            i = j + 1
        else:
            i += 1
    return "".join(out), strings


def line_of(text: str, pos: int) -> int:
    return text.count("\n", 0, pos) + 1


def _match_close(text: str, pos: int, open_: str = "(",
                 close: str = ")") -> int:
    """Index just past the bracket closing the one at ``pos``."""
    depth = 0
    for i in range(pos, len(text)):
        if text[i] == open_:
            depth += 1
        elif text[i] == close:
            depth -= 1
            if depth == 0:
                return i + 1
    return len(text)


class Source:
    """One file: its stripped text and string literals."""

    def __init__(self, rel: str, text: str):
        self.rel = rel
        self.raw = text
        self.text, self.strings = strip(text)

    def includes(self) -> list[tuple[int, str]]:
        """``(line, name)`` of each ``#include "name"`` (read from the raw
        text: the stripped one has lost the quoted name)."""
        return [(line_of(self.raw, m.start()), m.group(1))
                for m in re.finditer(r'^\s*#\s*include\s*"([^"]+)"',
                                     self.raw, re.M)]


def sources(root: str) -> list[Source]:
    base = os.path.join(root, KERNELS_DIR)
    out = []
    if not os.path.isdir(base):
        return out
    for pkg in sorted(os.listdir(base)):
        csrc = os.path.join(base, pkg, "csrc")
        if not os.path.isdir(csrc):
            continue
        for fn in sorted(os.listdir(csrc)):
            if fn.endswith(_SUFFIXES):
                with open(os.path.join(csrc, fn)) as f:
                    out.append(Source(os.path.join(KERNELS_DIR, pkg, "csrc",
                                                   fn), f.read()))
    return out


def units(root: str) -> list[list[Source]]:
    """Each ``.cu`` with the local headers it includes (transitively), the
    ``.cu`` first."""
    by_rel = {s.rel: s for s in sources(root)}
    out = []
    for s in by_rel.values():
        if not s.rel.endswith(".cu"):
            continue
        unit, stack = [], [s]
        while stack:
            cur = stack.pop(0)
            if cur in unit:
                continue
            unit.append(cur)
            for _, name in cur.includes():
                dep = by_rel.get(os.path.join(os.path.dirname(cur.rel), name))
                if dep is not None:
                    stack.append(dep)
        out.append(unit)
    return out


class Function:
    """A function definition found in a source: name, parameter text,
    body text and where they start."""

    def __init__(self, src: Source, name: str, head: str, params: str,
                 body_start: int, body: str):
        self.src = src
        self.name = name
        self.head = head
        self.params = params
        self.body_start = body_start
        self.body = body

    @property
    def is_global(self) -> bool:
        return "__global__" in self.head

    def line(self, offset: int) -> int:
        return line_of(self.src.text, self.body_start + offset)


_DEF = re.compile(r"\b([A-Za-z_]\w*)\s*\(")
_KEYWORDS = {"if", "for", "while", "switch", "return", "sizeof", "constexpr",
             "__launch_bounds__", "static_assert", "decltype", "alignas"}


def functions(src: Source) -> list[Function]:
    """Function definitions: ``name(params) [qualifiers] {`` at any depth
    outside another function body (namespaces are entered)."""
    text = src.text
    out: list[Function] = []
    pos = 0
    while True:
        m = _DEF.search(text, pos)
        if not m:
            return out
        name = m.group(1)
        p_open = m.end() - 1
        p_close = _match_close(text, p_open)
        rest = re.match(r"[\s\w:&\-\>\*]*\{", text[p_close:])
        head_start = text.rfind(";", 0, m.start())
        head_start = max(head_start, text.rfind("}", 0, m.start()),
                         text.rfind("{", 0, m.start()))
        head = text[head_start + 1:m.start()] + m.group(0)
        if (rest is None or name in _KEYWORDS
                or "=" in text[head_start + 1:m.start()]):
            pos = m.end()
            continue
        b_open = p_close + rest.end() - 1
        b_close = _match_close(text, b_open, "{", "}")
        out.append(Function(src, name, head, text[p_open + 1:p_close - 1],
                            b_open + 1, text[b_open + 1:b_close - 1]))
        pos = b_close
    return out


# ---------------------------------------------------------------------------
# GRID
# ---------------------------------------------------------------------------


def _operand_before(expr: str, i: int) -> str:
    """The operand ending just before index ``i`` (a bracketed group or a
    token)."""
    j = i - 1
    while j >= 0 and expr[j].isspace():
        j -= 1
    if j >= 0 and expr[j] == ")":
        depth = 0
        for k in range(j, -1, -1):
            if expr[k] == ")":
                depth += 1
            elif expr[k] == "(":
                depth -= 1
                if depth == 0:
                    # a cast or call head before the group belongs to it
                    return expr[k:j + 1]
        return expr[:j + 1]
    m = re.search(r"[\w\.]+$", expr[:j + 1])
    return m.group(0) if m else ""


def _operand_after(expr: str, i: int) -> str:
    m = re.match(r"\s*(\([^()]*\)|[\w\.]+)", expr[i + 1:])
    return m.group(1) if m else ""


def _norm(s: str) -> str:
    return re.sub(r"\s+", "", s)


def _unparen(s: str) -> str:
    s = _norm(s)
    while s.startswith("(") and _match_close(s, 0) == len(s):
        s = s[1:-1]
    return s


def divisions(expr: str):
    """``(numerator, divisor)`` of each integer ``/`` in ``expr``."""
    for m in re.finditer(r"(?<![/*])/(?![/*=])", expr):
        yield _operand_before(expr, m.start()), _operand_after(expr,
                                                               m.start())


def is_ceil_div(num: str, den: str) -> bool:
    """``(X + den - 1)`` or ``(X + k)`` with ``k = den - 1``."""
    n, d = _unparen(num), _unparen(den)
    if n.endswith(f"+{d}-1"):
        return True
    tail = re.search(r"\+(\d+)$", n)
    return bool(tail and d.isdigit() and int(tail.group(1)) == int(d) - 1)


def has_divisibility_evidence(unit: list[Source], num: str,
                              den: str) -> bool:
    x, b = re.escape(_unparen(num)), re.escape(_unparen(den))
    pat = re.compile(rf"\b{x}\s*%\s*\(?\s*{b}\b")
    return any(pat.search(s.text) for s in unit)


def launches(src: Source):
    """``(kernel name, grid expression, offset)`` of each ``<<<...>>>``."""
    for m in re.finditer(r"([A-Za-z_]\w*)\s*(?:<[^<>;]*(?:<[^<>;]*>[^<>;]*)*>"
                         r")?\s*<<<(.*?)>>>", src.text, re.S):
        cfg = m.group(2)
        depth, cut = 0, len(cfg)
        for i, c in enumerate(cfg):
            if c in "([{":
                depth += 1
            elif c in ")]}":
                depth -= 1
            elif c == "," and depth == 0:
                cut = i
                break
        yield m.group(1), cfg[:cut].strip(), m.start()


def grid_exprs(unit: list[Source], src: Source, grid: str) -> list[str]:
    """The grid expression, the definition of a name it is, and the
    ``return`` of each ``dim3``-returning helper it calls."""
    exprs = [grid]
    if re.fullmatch(r"\w+", grid):
        m = re.search(rf"\bdim3\s+{grid}\s*\(", src.text)
        if m:
            exprs.append(src.text[m.end() - 1:_match_close(src.text,
                                                           m.end() - 1)])
        m = re.search(rf"\b(?:{_INT_TYPES}|dim3)\s+{grid}\s*=\s*([^;]+);",
                      src.text)
        if m:
            exprs.append(m.group(1))
    helpers = {f.name: f for s in unit for f in functions(s)
               if re.match(r"\s*(?:static\s+)?(?:inline\s+)?dim3\b",
                           f.head.strip().split("\n")[-1])}
    for e in list(exprs):
        for call in re.findall(r"\b(\w+)\s*\(", e):
            h = helpers.get(call)
            if h is not None:
                exprs.extend(re.findall(r"\breturn\s+([^;]+);", h.body))
    return exprs


def _check_grid(unit: list[Source]) -> list[Finding]:
    found = []
    for src in unit:
        for kernel, grid, pos in launches(src):
            for e in grid_exprs(unit, src, grid):
                for num, den in divisions(e):
                    if not num or not den or is_ceil_div(num, den):
                        continue
                    if has_divisibility_evidence(unit, num, den):
                        continue
                    found.append(Finding(
                        "REPRO-CUDA-GRID", src.rel, line_of(src.text, pos),
                        f"grid of `{kernel}` divides `{_norm(num)} / "
                        f"{_norm(den)}` without the ceil-div idiom or "
                        f"divisibility evidence (`{_norm(num)} % "
                        f"{_norm(den)}`) in the source — a ragged trailing "
                        "tile is silently dropped",
                        f"launch `({_norm(num)} + {_norm(den)} - 1) / "
                        f"{_norm(den)}` blocks and guard the index, or "
                        f"refuse `{_norm(num)} % {_norm(den)} != 0`"))
    return found


# ---------------------------------------------------------------------------
# GUARD
# ---------------------------------------------------------------------------


def _params(fn: Function) -> tuple[set[str], set[str]]:
    """(pointer parameters, integer size parameters)."""
    ptrs, sizes = set(), set()
    for p in fn.params.split(","):
        p = p.strip()
        m = re.search(r"(\w+)\s*(?:\[\s*\])?$", p)
        if not m:
            continue
        name = m.group(1)
        if "*" in p:
            ptrs.add(name)
        elif re.match(rf"{_INT_TYPES}\b", p):
            sizes.add(name)
    return ptrs, sizes


def _statements(body: str):
    """``(offset, text)`` of each statement, split at ``;`` and braces."""
    start = 0
    for m in re.finditer(r"[;{}]", body):
        stmt = body[start:m.start() + 1]
        if stmt.strip(" \n\t;{}"):
            yield start + len(stmt) - len(stmt.lstrip()), stmt.lstrip()
        start = m.end()


_NAME = re.compile(r"(?<![\.\w])(?<!->)([A-Za-z_]\w*)")


def _guarded(fn: Function) -> tuple[bool, int]:
    """(guard before the first global access, that access's offset)."""
    ptrs, sizes = _params(fn)
    derived: set[str] = set()
    globals_ = set(ptrs)
    size_re = re.compile(r"\b(" + "|".join(map(re.escape, sizes)) + r")\b") \
        if sizes else None
    for off, stmt in _statements(fn.body):
        names = set(_NAME.findall(stmt))
        assign = re.match(r"\s*(?:[\w:<>\*&]+\s+)*?(\w+)\s*(?:\[[^\]]*\])?"
                          r"\s*=(?!=)", stmt)
        target = assign.group(1) if assign else None
        uses_global = names & globals_
        is_index = "blockIdx" in names or (names & derived)
        # a comparison, a clamp, or a call handed the index and the size
        compares = size_re is not None and size_re.search(stmt) and (
            re.search(r"[<>]=?|\b\w+\s*\(", stmt))
        if uses_global:
            # pointer arithmetic into a new pointer is not an access
            if (target is not None and "*" in stmt[:assign.end()]
                    and not re.search(r"\w\s*\[|\*\s*\w+\s*=", stmt[
                        assign.end():])):
                globals_.add(target)
                continue
            if is_index and compares:
                return True, off
            return False, off
        if is_index and compares:
            return True, off
        if target is not None and is_index:
            derived.add(target)
    return True, len(fn.body)


def _ceil_launched(unit: list[Source]) -> set[str]:
    out = set()
    for src in unit:
        for kernel, grid, _ in launches(src):
            for e in grid_exprs(unit, src, grid):
                if any(is_ceil_div(n, d) for n, d in divisions(e)):
                    out.add(kernel)
    return out


def _check_guard(unit: list[Source]) -> list[Finding]:
    found = []
    ceil = _ceil_launched(unit)
    for src in unit:
        for fn in functions(src):
            if not fn.is_global or fn.name not in ceil:
                continue
            ok, off = _guarded(fn)
            if not ok:
                found.append(Finding(
                    "REPRO-CUDA-GUARD", src.rel, fn.line(off),
                    f"kernel `{fn.name}` runs on a ceil-div grid but reads "
                    "or writes global memory before comparing its block "
                    "index with a size parameter — the last block runs "
                    "past the data",
                    "return early (`if (col >= d) return;`) or hand the "
                    "size to the loader before the first access"))
    return found


# ---------------------------------------------------------------------------
# ACC
# ---------------------------------------------------------------------------


_WGMMA = re.compile(r"wgmma\.mma_async\.sync\.aligned\.m\d+n\d+k\d+\.(\w+)\.")


def _check_acc(unit: list[Source]) -> list[Finding]:
    found = []
    for src in unit:
        narrow = set()
        for t in _NARROW:
            for m in re.finditer(rf"\b{t}\b\s*(?:const\s*)?\**\s*"
                                 rf"(?:__restrict__\s*)?(\w+)", src.text):
                narrow.add(m.group(1))
        for name in sorted(narrow):
            for m in re.finditer(rf"(?:\*\s*)?\b{name}\b\s*(?:\[[^\]]*\]\s*)*"
                                 r"\+=", src.text):
                found.append(Finding(
                    "REPRO-CUDA-ACC", src.rel, line_of(src.text, m.start()),
                    f"`+=` into the 16-bit `{name}` loses low bits every "
                    "step",
                    "accumulate in a float register and convert once"))
        for line, s in src.strings:
            m = _WGMMA.search(s)
            if m and m.group(1) not in ("f32", "s32"):
                found.append(Finding(
                    "REPRO-CUDA-ACC", src.rel, line,
                    f"wgmma accumulates in {m.group(1)}",
                    "use the .f32 accumulator form"))
    return found


# ---------------------------------------------------------------------------
# MASK
# ---------------------------------------------------------------------------


def _maps_nan(text: str) -> bool:
    """A statement that maps NaN to ``BIG``."""
    return any("isnan" in st and "BIG" in st
               for _, st in _statements(text))


def _check_mask(unit: list[Source]) -> list[Finding]:
    found = []
    fns = {f.name: f for s in unit for f in functions(s)}
    sorts = {n for n in fns if _SORT_CALL.match(n + "(")}
    for src in unit:
        for fn in functions(src):
            if not fn.is_global:
                continue
            m = _SORT_CALL.search(fn.body)
            if m is None or m.group(1) not in sorts | {
                    "sort_bitonic", "sort_exact", "compare_exchange"}:
                continue
            before = fn.body[:m.start()]
            ok = _maps_nan(before) or any(
                _maps_nan(fns[c].body)
                for c in re.findall(r"\b(\w+)\s*(?:<[^;(){}]*>)?\s*\(", before)
                if c in fns and c != fn.name)
            if not ok:
                found.append(Finding(
                    "REPRO-CUDA-MASK", src.rel, fn.line(m.start()),
                    f"kernel `{fn.name}` runs the sorting network "
                    f"`{m.group(1)}` without first mapping NaN to the "
                    "finite `BIG` sentinel: NaN poisons fminf/fmaxf "
                    "compare-exchanges",
                    "`if (isnan(v)) v = BIG;` on load, as cwise_median.cu's "
                    "load_padded does"))
    return found


# -- registration -----------------------------------------------------------


def _make_check(fn):
    def check(root: str) -> list[Finding]:
        found, seen = [], set()
        for unit in units(root):
            for f in fn(unit):
                if (f.path, f.line, f.message) not in seen:  # shared headers
                    seen.add((f.path, f.line, f.message))
                    found.append(f)
        return found
    return check


register(Rule(
    rule_id="REPRO-CUDA-GRID",
    scope="repo",
    description="every grid dimension made by division uses the ceil-div "
                "idiom or has divisibility evidence (`X % B`) in the source",
    check=_make_check(_check_grid),
    fix_hint="ceil-div the grid and guard the index",
))

register(Rule(
    rule_id="REPRO-CUDA-GUARD",
    scope="repo",
    description="a kernel on a ceil-div grid compares its block-derived "
                "index with a size parameter before its first global access",
    check=_make_check(_check_guard),
    fix_hint="early return on the index past the size",
))

register(Rule(
    rule_id="REPRO-CUDA-ACC",
    scope="repo",
    description="no `+=` into a `__nv_bfloat16`/`__half` variable, array or "
                "pointer; every `wgmma` accumulates in f32",
    check=_make_check(_check_acc),
    fix_hint="accumulate in f32",
))

register(Rule(
    rule_id="REPRO-CUDA-MASK",
    scope="repo",
    description="a kernel with a sorting network maps NaN to `BIG` before "
                "its first compare-exchange",
    check=_make_check(_check_mask),
    fix_hint="map NaN to BIG on load",
))

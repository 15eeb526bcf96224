"""Layer-1+ dataflow: the port's call graph and an interprocedural,
flow-sensitive taint engine over ASTs.

Two reusable pieces live here, both purely static (nothing checked is
ever imported):

* the **step closure** (:class:`CallGraph`): the reference seeds the
  functions that run inside a trace from JAX's names (``jax.jit``,
  ``lax.scan``, ...), which mean nothing in the port. Here the seeds are
  declared — :data:`ROOTS`, the ``run_epoch`` bodies of ``EpochEngine``
  and ``ProtocolEngine``, which run once per protocol step — and closed
  over the call graph to a fixpoint: nested defs, same-class methods,
  step closures stored on ``self`` by a factory, names imported from
  other modules, and methods called on other objects (by name, over every
  class: a superset). REPRO-HOST-SYNC asks which functions it holds.
* a **taint engine** (:class:`TaintEngine`) — an abstract interpreter
  over a whole set of modules with a small lattice
  ``CLEAN < WEIGHTS < TAINTED`` plus two non-data payloads (closures and
  aggregator specs). Functions are analyzed flow-sensitively statement
  by statement; calls to local closures, sibling methods and uniquely
  named top-level functions in *other* modules are inlined (depth- and
  cycle-guarded), so a source in ``core/attacks.py`` is tracked through
  the protocol's pull to wherever it lands.

The lattice is policy-parameterized (:class:`Policy`): *sources* mint
``TAINTED`` values with a provenance trace, *sanitizers* return
``CLEAN``, *weight fns* return ``WEIGHTS`` (robust selection weights —
contracting them against a tainted stack via ``matmul``/``@`` is
the selection-based sanitization pattern of ``agg.registry`` and yields
``CLEAN``), and *sinks* report any ``TAINTED`` argument together with
the recorded file:line witness path. REPRO-TAINT-BYZ instantiates the
policy from the port's ``agg/registry.py`` AST (see
``rules/taint_byz.py``).
"""
from __future__ import annotations

import ast
import dataclasses
import os

# ---------------------------------------------------------------------------
# the step closure
# ---------------------------------------------------------------------------

#: the per-step loops: (path under the package, class, method)
ROOTS = (("core/engine.py", "EpochEngine", "run_epoch"),
         ("core/protocol.py", "ProtocolEngine", "run_epoch"))

PACKAGE = os.path.join("src", "repro_torch")

#: method names of tensors and of Python's containers and strings: a call
#: ``x.view(...)`` on some object is not resolved to a port class's method
#: of the same name (``RankView.view``), which would drag every such class
#: into the closure
_BUILTIN_METHODS = frozenset({
    "view", "size", "reshape", "to", "sum", "mean", "max", "min", "all",
    "any", "float", "double", "int", "long", "bool", "half", "bfloat16",
    "item", "numel", "clone", "copy_", "expand", "flatten", "unbind",
    "split", "chunk", "index_select", "gather", "scatter", "scatter_",
    "norm", "abs", "sqrt", "detach", "contiguous", "unsqueeze", "squeeze",
    "permute", "transpose", "zero_", "fill_", "add_", "mul_", "div_",
    "sub_", "masked_fill", "where", "type", "dim", "cuda", "cpu", "numpy",
    "tolist", "backward", "new_empty", "new_zeros", "view_as", "get",
    "items", "keys", "values", "append", "extend", "pop", "update", "join",
    "format", "startswith", "endswith", "strip", "replace", "copy",
    "setdefault", "add", "discard", "remove", "insert", "index", "count",
    "sort", "encode", "decode", "read", "write", "close"})

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _dotted(node: ast.AST) -> str:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def func_defs(tree: ast.AST) -> list[ast.AST]:
    """Every function-ish node, in ast.walk (breadth-first) order."""
    return [n for n in ast.walk(tree) if isinstance(n, _FUNC_NODES)]


def lexical_parents(tree: ast.AST) -> dict[ast.AST, ast.AST]:
    """Inner function -> nearest enclosing function."""
    parents: dict[ast.AST, ast.AST] = {}
    for fn in func_defs(tree):
        for child in ast.walk(fn):
            if child is not fn and isinstance(child, _FUNC_NODES):
                parents.setdefault(child, fn)
    return parents


def owner_map(tree: ast.AST) -> dict[ast.AST, ast.AST]:
    """Node -> innermost enclosing function. func_defs walks outer defs
    before their inner defs, so plain assignment lets the innermost win."""
    owner: dict[ast.AST, ast.AST] = {}
    for fn in func_defs(tree):
        body = fn.body if not isinstance(fn, ast.Lambda) else [fn.body]
        for stmt in body:
            for node in ast.walk(stmt):
                owner[node] = fn
    return owner


def module_name(rel: str) -> str:
    """src/repro_torch/core/engine.py -> repro_torch.core.engine (a
    package's ``__init__`` -> the package)."""
    mod = os.path.relpath(rel, "src")[:-3].replace(os.sep, ".")
    return mod[:-len(".__init__")] if mod.endswith(".__init__") else mod


class CallGraph:
    """Functions of ``modules`` (rel path -> ast.Module) and what each
    may call, resolved by name (see the module docstring)."""

    def __init__(self, modules: dict[str, ast.Module]):
        self.modules = modules
        self.path_of: dict[ast.AST, str] = {}
        self.class_of: dict[ast.AST, ast.ClassDef] = {}
        self.parents: dict[ast.AST, ast.AST] = {}
        self.by_module = {module_name(p): p for p in modules}
        self.top: dict[str, dict[str, ast.AST]] = {}     # path -> name -> def
        self.top_by_name: dict[str, list[ast.AST]] = {}
        self.methods_by_name: dict[str, list[ast.AST]] = {}
        # path -> alias -> dotted name
        self.imports: dict[str, dict[str, str]] = {}
        for path, tree in modules.items():
            self.top[path] = {}
            for node in tree.body:
                if isinstance(node, _DEFS):
                    self.top[path][node.name] = node
                    self.top_by_name.setdefault(node.name, []).append(node)
                elif isinstance(node, ast.ClassDef):
                    for m in node.body:
                        if isinstance(m, _DEFS):
                            self.class_of[m] = node
                            self.methods_by_name.setdefault(
                                m.name, []).append(m)
            for fn in func_defs(tree):
                self.path_of[fn] = path
            self.parents.update(lexical_parents(tree))
            self.imports[path] = self._imports(tree, module_name(path),
                                               path.endswith("__init__.py"))

    @staticmethod
    def _imports(tree: ast.Module, mod: str, is_pkg: bool) -> dict:
        pkg = mod if is_pkg else mod.rpartition(".")[0]
        out: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    out[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    parts = pkg.split(".")
                    parts = parts[:len(parts) - (node.level - 1)]
                    base = ".".join(parts + ([node.module] if node.module
                                             else []))
                for a in node.names:
                    out[a.asname or a.name] = f"{base}.{a.name}"
        return out

    # -- resolution -------------------------------------------------------
    def _top_in(self, dotted: str, name: str) -> list[ast.AST]:
        """Top-level ``name`` of the module ``dotted``, or of any module
        of the package ``dotted``."""
        out = []
        for mod, path in self.by_module.items():
            if mod == dotted or mod.startswith(dotted + "."):
                fn = self.top[path].get(name)
                if fn is not None:
                    out.append(fn)
        return out

    def _by_name(self, fn: ast.AST, name: str) -> list[ast.AST]:
        path = self.path_of[fn]
        scope = fn
        while scope is not None:              # nested defs, innermost first
            for node in ast.walk(scope):
                if (isinstance(node, _DEFS) and node.name == name
                        and node is not scope
                        and self.parents.get(node) is scope):
                    return [node]
            scope = self.parents.get(scope)
        if name in self.top[path]:
            return [self.top[path][name]]
        target = self.imports[path].get(name)
        if target is not None:
            mod, _, attr = target.rpartition(".")
            found = self._top_in(mod, attr)
            if found:
                return found
        cands = self.top_by_name.get(name, [])
        return cands if len(cands) == 1 else []

    def _returned(self, factory: ast.AST) -> list[ast.AST]:
        """The nested defs a factory returns (a step builder's step)."""
        names = {n.value.id for n in ast.walk(factory)
                 if isinstance(n, ast.Return)
                 and isinstance(n.value, ast.Name)}
        return [n for n in ast.walk(factory)
                if isinstance(n, _DEFS) and n.name in names
                and self.parents.get(n) is factory]

    def _self_attr(self, fn: ast.AST, attr: str) -> list[ast.AST]:
        cls = self.class_of.get(fn)
        while cls is None and fn is not None:
            fn = self.parents.get(fn)
            cls = self.class_of.get(fn) if fn is not None else None
        if cls is None:
            return []
        for m in cls.body:
            if isinstance(m, _DEFS) and m.name == attr:
                return [m]
        out = []
        for m in cls.body:                  # self.attr = factory(...)
            if not isinstance(m, _DEFS):
                continue
            for node in ast.walk(m):
                if (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Call)
                        and any(_dotted(t) == f"self.{attr}"
                                for t in node.targets)):
                    head = _dotted(node.value.func)
                    for f in self._by_name(m, head.rpartition(".")[2]):
                        out.extend(self._returned(f))
        return out

    def callees(self, fn: ast.AST) -> list[ast.AST]:
        out: list[ast.AST] = []
        path = self.path_of[fn]
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Name):
                out.extend(self._by_name(fn, f.id))
            elif isinstance(f, ast.Attribute):
                base = f.value
                if isinstance(base, ast.Name) and base.id == "self":
                    out.extend(self._self_attr(fn, f.attr))
                elif (isinstance(base, ast.Name)
                      and base.id in self.imports[path]):
                    out.extend(self._top_in(self.imports[path][base.id],
                                            f.attr))
                elif f.attr not in _BUILTIN_METHODS:
                    out.extend(self.methods_by_name.get(f.attr, []))
        return out

    def closure(self, roots: list[ast.AST]) -> set[ast.AST]:
        """``roots`` and everything they may call or define, to a
        fixpoint."""
        seen: set[ast.AST] = set()
        stack = list(roots)
        while stack:
            fn = stack.pop()
            if fn in seen:
                continue
            seen.add(fn)
            stack.extend(c for c in self.callees(fn) if c not in seen)
            stack.extend(n for n in ast.walk(fn)
                         if isinstance(n, _FUNC_NODES) and n is not fn
                         and n not in seen)
        return seen

    def roots(self) -> list[ast.AST]:
        out = []
        for rel, cls_name, meth in ROOTS:
            tree = self.modules.get(os.path.join(PACKAGE, rel))
            if tree is None:
                continue
            for node in tree.body:
                if isinstance(node, ast.ClassDef) and node.name == cls_name:
                    out.extend(m for m in node.body
                               if isinstance(m, _DEFS) and m.name == meth)
        return out


def step_functions(modules: dict[str, ast.Module]) -> tuple[set, CallGraph]:
    """(the closure of :data:`ROOTS`, the call graph it came from)."""
    graph = CallGraph(modules)
    return graph.closure(graph.roots()), graph


# ---------------------------------------------------------------------------
# the taint lattice
# ---------------------------------------------------------------------------

CLEAN, WEIGHTS, TAINTED = 0, 1, 2

_TRACE_CAP = 10


@dataclasses.dataclass(frozen=True)
class Val:
    """One abstract value: a lattice point plus optional payloads.

    ``trace`` carries the provenance of a TAINTED value as
    ``(("path", line, "desc"), ...)``. ``func`` holds a closure
    ``(def-node, env-snapshot, path)``; ``spec`` an aggregator handle
    ``(robust, masked_ok, name)`` minted by ``agg.get(...)``.
    """
    kind: int = CLEAN
    trace: tuple = ()
    func: tuple | None = None
    spec: tuple | None = None


_CLEAN = Val()


def join(*vals: Val) -> Val:
    out = _CLEAN
    for v in vals:
        if v.kind > out.kind or (out.func is None and v.func is not None) \
                or (out.spec is None and v.spec is not None):
            out = Val(max(out.kind, v.kind),
                      v.trace if v.kind >= out.kind else out.trace,
                      out.func or v.func, out.spec or v.spec)
    return out


def _extend(val: Val, path: str, line: int, desc: str) -> Val:
    if val.kind != TAINTED or len(val.trace) >= _TRACE_CAP:
        return val
    if val.trace and val.trace[-1][:2] == (path, line):
        return val
    return dataclasses.replace(val, trace=val.trace + ((path, line, desc),))


@dataclasses.dataclass(frozen=True)
class Policy:
    """What taints, what launders, what must stay clean."""
    sources: frozenset            # call names minting TAINTED
    sanitizers: frozenset         # call names returning CLEAN
    weight_fns: frozenset         # call names returning WEIGHTS
    robust_rules: dict            # rule name -> supports_masked_delivery
    all_rules: frozenset = frozenset()   # every registered rule name
    spec_getters: frozenset = frozenset({"agg.get", "registry.get"})
    sink_ctors: frozenset = frozenset()       # ctor names with sink kwargs
    sink_kwargs: frozenset = frozenset()      # kwarg names that are sinks
    sink_calls: frozenset = frozenset()       # calls whose args are sinks


@dataclasses.dataclass(frozen=True)
class SinkHit:
    path: str
    line: int
    sink: str                     # human description of the sink
    trace: tuple                  # provenance of the tainted value

    def witness(self) -> str:
        hops = [f"{p}:{ln} {d}" for p, ln, d in self.trace]
        hops.append(f"{self.path}:{self.line} sink {self.sink}")
        return " -> ".join(hops)


# combinators that *return* the function they are given (possibly wrapped)
_WRAPPERS = {"torch.vmap", "torch.func.vmap", "vmap", "torch.func.grad",
             "torch.func.grad_and_value", "torch.compile", "partial",
             "functools.partial"}
# combinators that *run* the function(s) they are given
_RUNNERS = {"torch.utils.checkpoint.checkpoint", "checkpoint.checkpoint",
            "torch.func.functional_call", "functional_call"}
# dot-like contractions where WEIGHTS x TAINTED is the selection-based
# sanitization pattern (robust convex combination)
_DOT_CALLS = {"dot_general", "dot", "matmul", "einsum", "tensordot"}

_DEPTH_CAP = 24


class TaintEngine:
    """Whole-program taint over ``modules``: rel-path -> ast.Module."""

    def __init__(self, modules: dict[str, ast.Module], policy: Policy):
        self.modules = modules
        self.policy = policy
        self.hits: list[SinkHit] = []
        self._stack: list[int] = []      # active funcdef ids (cycle guard)
        self._entered: set[int] = set()  # funcdefs analyzed as entries
        self._pending: list[Val] = []    # closures defined but never applied
        self._seen_sinks: set[tuple] = set()
        # unambiguous top-level defs across all modules, for cross-module
        # inlining by bare name
        counts: dict[str, int] = {}
        self._global_defs: dict[str, tuple] = {}
        for path, tree in modules.items():
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    counts[node.name] = counts.get(node.name, 0) + 1
                    self._global_defs[node.name] = (node, path)
        for name, n in counts.items():
            if n > 1:
                del self._global_defs[name]

    # -- public -----------------------------------------------------------
    def run(self, entry_paths: set[str] | None = None) -> list[SinkHit]:
        # entry points are TOP-LEVEL functions and class methods only;
        # nested defs are reached as closures (with their captured env)
        # via the pending queue, never with an empty env.
        for path, tree in sorted(self.modules.items()):
            if entry_paths is not None and path not in entry_paths:
                continue
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._entry(Val(func=(node, {}, path)))
                elif isinstance(node, ast.ClassDef):
                    ms = {m.name: m for m in node.body
                          if isinstance(m, ast.FunctionDef)}
                    for m in ms.values():
                        self._entry(Val(func=(m, {}, path)), ms)
        # drain closures that were defined but never called: their bodies
        # still hold flows (step builders returning step fns)
        while self._pending:
            self._entry(self._pending.pop())
        return self.hits

    # -- entry/closure machinery ------------------------------------------
    def _entry(self, fval: Val, siblings: dict | None = None):
        node = fval.func[0]
        if id(node) in self._entered:
            return
        self._entered.add(id(node))
        self._apply(fval, [], {}, siblings=siblings or {})

    def _apply(self, fval: Val, args: list[Val], kwargs: dict[str, Val],
               siblings: dict | None = None) -> Val:
        node, env0, path = fval.func
        if id(node) in self._stack or len(self._stack) >= _DEPTH_CAP:
            return join(*args, *kwargs.values())
        env = dict(env0)
        a = node.args
        pos = list(a.posonlyargs) + list(a.args)
        if len(args) == len(pos) or (args and not a.vararg
                                     and len(args) <= len(pos)):
            for p, v in zip(pos, args):
                env[p.arg] = v
            rest = args[len(pos):]
        else:  # combinator application / arity mismatch: smear the join
            smear = join(*args, *kwargs.values())
            for p in pos + list(a.kwonlyargs):
                env[p.arg] = smear
            rest = args
        if a.vararg:
            env[a.vararg.arg] = join(*rest) if rest else _CLEAN
        for name, v in kwargs.items():
            env[name] = v
        if a.kwarg:
            env[a.kwarg.arg] = join(*kwargs.values()) if kwargs else _CLEAN
        self._stack.append(id(node))
        try:
            frame = _Frame(self, path, env,
                           siblings if siblings is not None else {})
            if isinstance(node, ast.Lambda):
                ret = frame.eval(node.body)
            else:
                frame.exec_block(node.body)
                ret = frame.ret
            self._entered.add(id(node))
        finally:
            self._stack.pop()
        for c in frame.defined:
            if id(c.func[0]) not in self._entered:
                self._pending.append(c)
        return ret

    def _sink(self, path: str, line: int, sink: str, val: Val):
        key = (path, line, sink)
        if key in self._seen_sinks:
            return
        self._seen_sinks.add(key)
        self.hits.append(SinkHit(path, line, sink, val.trace))


class _Frame:
    """Flow-sensitive walk of one function body."""

    def __init__(self, engine: TaintEngine, path: str, env: dict,
                 siblings: dict):
        self.e = engine
        self.path = path
        self.env = env
        self.siblings = siblings      # same-class methods, for self.m(...)
        self.ret = _CLEAN
        self.defined: list[Val] = []  # closures defined in this frame

    # -- statements -------------------------------------------------------
    def exec_block(self, body):
        for stmt in body:
            self.exec(stmt)

    def exec(self, stmt):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fv = Val(func=(stmt, dict(self.env), self.path))
            self.env[stmt.name] = fv
            self.defined.append(fv)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self.ret = join(self.ret, self.eval(stmt.value))
        elif isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = (stmt.value if not isinstance(stmt, ast.AugAssign)
                     else stmt.value)
            if value is None:
                return
            val = self.eval(value)
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for t in targets:
                self._assign(t, val, stmt.lineno,
                             aug=isinstance(stmt, ast.AugAssign))
        elif isinstance(stmt, ast.Expr):
            self.eval(stmt.value)
        elif isinstance(stmt, ast.If):
            self.eval(stmt.test)
            self.exec_block(stmt.body)
            self.exec_block(stmt.orelse)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            it = self.eval(stmt.iter)
            self._assign(stmt.target, it, stmt.lineno)
            self.exec_block(stmt.body)   # twice: crude loop fixpoint
            self.exec_block(stmt.body)
            self.exec_block(stmt.orelse)
        elif isinstance(stmt, ast.While):
            self.eval(stmt.test)
            self.exec_block(stmt.body)
            self.exec_block(stmt.body)
            self.exec_block(stmt.orelse)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                v = self.eval(item.context_expr)
                if item.optional_vars is not None:
                    self._assign(item.optional_vars, v, stmt.lineno)
            self.exec_block(stmt.body)
        elif isinstance(stmt, ast.Try):
            self.exec_block(stmt.body)
            for h in stmt.handlers:
                self.exec_block(h.body)
            self.exec_block(stmt.orelse)
            self.exec_block(stmt.finalbody)
        elif isinstance(stmt, (ast.Raise, ast.Assert)):
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self.eval(child)
        # Import/Global/Pass/Delete/ClassDef: no dataflow tracked

    def _assign(self, target, val: Val, lineno: int, aug: bool = False):
        if isinstance(target, ast.Name):
            if aug:
                val = join(self.env.get(target.id, _CLEAN), val)
            if val.kind == TAINTED:
                val = _extend(val, self.path, lineno,
                              f"`{target.id} = ...`")
            self.env[target.id] = val
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._assign(el, val, lineno)
        elif isinstance(target, ast.Starred):
            self._assign(target.value, val, lineno)
        # Attribute/Subscript targets: object fields are not tracked

    # -- expressions ------------------------------------------------------
    def eval(self, node) -> Val:
        if node is None or isinstance(node, ast.Constant):
            return _CLEAN
        if isinstance(node, ast.Name):
            return self.env.get(node.id, _CLEAN)
        if isinstance(node, ast.Attribute):
            # tensor metadata: a Byzantine peer controls values, never
            # shapes/dtypes — reading them off a tainted tensor yields a
            # clean scalar
            if node.attr in ("shape", "dtype", "ndim", "size", "itemsize"):
                return _CLEAN
            return self.eval(node.value)
        if isinstance(node, ast.Call):
            return self._call(node)
        if isinstance(node, ast.Lambda):
            return Val(func=(node, dict(self.env), self.path))
        if isinstance(node, ast.BinOp):
            lv, rv = self.eval(node.left), self.eval(node.right)
            if isinstance(node.op, ast.MatMult) and \
                    {lv.kind, rv.kind} == {WEIGHTS, TAINTED}:
                return _CLEAN          # robust convex combination
            return join(lv, rv)
        if isinstance(node, ast.Subscript):
            return join(self.eval(node.value), self.eval(node.slice))
        if isinstance(node, ast.Starred):
            return self.eval(node.value)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return join(*(self.eval(el) for el in node.elts)) \
                if node.elts else _CLEAN
        if isinstance(node, ast.Dict):
            parts = [self.eval(v) for v in node.values if v is not None]
            return join(*parts) if parts else _CLEAN
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            for gen in node.generators:
                self._assign(gen.target, self.eval(gen.iter), node.lineno)
                for cond in gen.ifs:
                    self.eval(cond)
            if isinstance(node, ast.DictComp):
                return join(self.eval(node.key), self.eval(node.value))
            return self.eval(node.elt)
        if isinstance(node, (ast.IfExp,)):
            self.eval(node.test)
            return join(self.eval(node.body), self.eval(node.orelse))
        if isinstance(node, (ast.BoolOp,)):
            return join(*(self.eval(v) for v in node.values))
        if isinstance(node, (ast.Compare,)):
            return join(self.eval(node.left),
                        *(self.eval(c) for c in node.comparators))
        if isinstance(node, ast.UnaryOp):
            return self.eval(node.operand)
        if isinstance(node, (ast.Await, ast.YieldFrom)):
            return self.eval(node.value)
        if isinstance(node, ast.Yield):
            return self.eval(node.value) if node.value else _CLEAN
        if isinstance(node, ast.JoinedStr):
            return _CLEAN
        if isinstance(node, ast.NamedExpr):
            v = self.eval(node.value)
            self._assign(node.target, v, node.lineno)
            return v
        return _CLEAN

    # -- calls ------------------------------------------------------------
    def _call(self, node: ast.Call) -> Val:
        pol = self.e.policy
        name = _dotted(node.func)
        terminal = name.split(".")[-1] if name else ""
        args = [self.eval(a) for a in node.args]
        kwargs = {kw.arg: self.eval(kw.value) for kw in node.keywords
                  if kw.arg}
        star_kw = [self.eval(kw.value) for kw in node.keywords
                   if kw.arg is None]
        allv = args + list(kwargs.values()) + star_kw
        recv = (self.eval(node.func.value)
                if isinstance(node.func, ast.Attribute) else _CLEAN)

        self._check_sinks(node, terminal, args, kwargs, recv)

        # 1. sources mint taint
        if terminal in pol.sources:
            return Val(TAINTED,
                       ((self.path, node.lineno, f"source `{terminal}(...)`"),))
        # 2. registry spec getters: agg.get("median") -> spec handle
        is_getter = name in pol.spec_getters or (
            terminal == "get" and node.args
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value in pol.all_rules)
        if is_getter:
            rule = None
            if node.args and isinstance(node.args[0], ast.Constant):
                rule = node.args[0].value
            if rule is not None:
                robust = rule in pol.robust_rules
                masked_ok = pol.robust_rules.get(rule, False)
                return Val(spec=(robust, masked_ok, rule))
            return Val(spec=(True, True, None))   # dynamic name: runtime
                                                  # validate() owns the bound
        # 3. resolve the callee expression to a closure / spec handle
        if isinstance(node.func, ast.Call):
            fv = self.eval(node.func)     # e.g. agg.get("median")(x, mask=m)
        elif isinstance(node.func, ast.Attribute):
            fv = recv if (recv.func or recv.spec) else _CLEAN
        elif isinstance(node.func, ast.Name):
            fv = self.env.get(node.func.id, _CLEAN)
        else:
            fv = _CLEAN
        # calling a spec handle: the sanitization point
        if fv.spec is not None and fv.func is None:
            robust, masked_ok, rule = fv.spec
            tainted_in = join(*allv)
            if not robust:
                return _extend(tainted_in, self.path, node.lineno,
                               f"non-robust rule `{rule}` does not launder")
            if "mask" in kwargs and not masked_ok:
                return _extend(tainted_in, self.path, node.lineno,
                               f"`{rule}` lacks masked-delivery support; "
                               "traced mask not laundered")
            return _CLEAN
        # 4. direct sanitizer / weight-fn calls by name
        if terminal in pol.sanitizers:
            return _CLEAN
        if terminal in pol.weight_fns:
            return Val(WEIGHTS)
        # 5. combinators
        if name in _WRAPPERS or terminal in _WRAPPERS:
            for v in allv:
                if v.func is not None:
                    return v            # vmap(f)/jit(f)/partial(f,..): still f
            return join(*allv)
        if name in _RUNNERS or terminal in _RUNNERS:
            closures = [v for v in allv if v.func is not None]
            data = [v for v in allv if v.func is None]
            out = [self.e._apply(c, data, {}) for c in closures]
            # the closures saw the data as args, so their joined result
            # models the combinator output — including any laundering
            if out:
                return join(*out)
            return join(*data) if data else _CLEAN
        # 6. local closure / sibling method / unambiguous global function
        if fv.func is not None:
            return self.e._apply(fv, args, kwargs, siblings=self.siblings)
        if (isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "self"
                and terminal in self.siblings):
            m = self.siblings[terminal]
            return self.e._apply(Val(func=(m, dict(self.env), self.path)),
                                 [_CLEAN] + args, kwargs,
                                 siblings=self.siblings)
        if isinstance(node.func, ast.Name) and \
                terminal in self.e._global_defs:
            gdef, gpath = self.e._global_defs[terminal]
            return self.e._apply(Val(func=(gdef, {}, gpath)), args, kwargs)
        # 7. unknown call: propagate; apply any closure-valued args so
        #    combinators like tree_map(op, tree) still flow through
        closures = [v for v in allv if v.func is not None]
        data = [v for v in allv if v.func is None] + [recv]
        if closures:
            # tree_map(op, tree) and friends: the applied closures'
            # result models the output (they received the data as args)
            return join(*(self.e._apply(c, data, {}) for c in closures))
        if terminal in _DOT_CALLS:
            kinds = {v.kind for v in allv}
            if {WEIGHTS, TAINTED} <= kinds:
                return _CLEAN           # robust convex combination
        return join(*data) if data else _CLEAN

    def _check_sinks(self, node: ast.Call, terminal: str, args, kwargs,
                     recv: Val):
        pol = self.e.policy
        is_ctor = terminal in pol.sink_ctors
        is_replace = terminal in ("_replace", "replace") and \
            recv.kind != TAINTED  # a wholly-tainted obj is reported upstream
        if is_ctor or is_replace:
            for kw, val in kwargs.items():
                if kw in pol.sink_kwargs and val.kind == TAINTED:
                    self.e._sink(self.path, node.lineno,
                                 f"`{terminal}({kw}=...)`", val)
        if terminal in pol.sink_calls:
            for val in args + list(kwargs.values()):
                if val.kind == TAINTED:
                    self.e._sink(self.path, node.lineno,
                                 f"`{terminal}(...)`", val)
                    break

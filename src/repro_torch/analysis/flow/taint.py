"""Tracer-taint analysis for staged bodies.

Inside a body staged by ``torch.compile`` / ``torch.jit`` /
``torch.func.vmap`` / ``torch.func.grad`` (or recorded by a
``torch.cuda.graph`` capture), function parameters and the results of
``torch.*`` calls are *traced* tensors.  Python-level control flow
(``if``/``while``/``assert``), host materialization (``np.asarray``,
``float()``, ``.item()``, ``.tolist()``, ``.numpy()``) and host side
effects (``print``/``open``) on a traced value either break the graph or
— worse — silently bake one traced value into the compiled program or the
recorded graph.  :class:`TaintAnalyzer` propagates a taint bit
through a staged function's locals and follows calls into *project*
functions (helpers called from a staged body are analyzed under the
tainted arguments too, depth-limited and memoized), reporting each
violation at its source line in the module that contains it.

Deliberate un-taints: ``x.shape`` / ``x.ndim`` / ``x.dtype``,
``x.size(i)`` / ``x.dim()`` / ``x.numel()`` / ``x.stride(i)`` and
``len(x)`` are Python values even on traced tensors, so arithmetic on
shapes never taints — the analysis only fires on *data*-dependent control
flow.
"""
from __future__ import annotations

import ast
from typing import NamedTuple, Optional

from .modules import dotted
from .modules import ModuleInfo, ProjectIndex

__all__ = ["TaintFinding", "TaintAnalyzer"]

_SHAPE_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda"}
_SHAPE_METHODS = {"size", "dim", "numel", "stride", "is_contiguous",
                  "element_size"}
_MATERIALIZE_METHODS = {"tolist", "item", "numpy"}
_MATERIALIZE_BUILTINS = {"float", "int", "bool", "complex"}
_HOST_CALLS = {"print", "open", "input", "breakpoint"}
_UNTAINT_BUILTINS = {"len", "range", "enumerate", "isinstance", "type",
                     "hasattr", "getattr"}


class TaintFinding(NamedTuple):
    module: ModuleInfo
    node: ast.AST
    kind: str          # "branch" | "assert" | "materialize" | "host"
    detail: str


class _Scope:
    __slots__ = ("tainted", "parent")

    def __init__(self, tainted: set[str],
                 parent: Optional["_Scope"] = None):
        self.tainted = tainted
        self.parent = parent

    def is_tainted(self, name: str) -> bool:
        s: Optional[_Scope] = self
        while s is not None:
            if name in s.tainted:
                return True
            s = s.parent
        return False


class TaintAnalyzer:
    """Interprocedural tracer-taint over one staged entry function (or one
    ``torch.cuda.graph`` capture body)."""

    def __init__(self, index: ProjectIndex, max_depth: int = 3):
        self.index = index
        self.max_depth = max_depth
        self.findings: list[TaintFinding] = []
        # (module, name, lineno, tainted-param mask) -> returns_tainted
        self._memo: dict[tuple, bool] = {}
        self._active: set[tuple] = set()

    # -- public entry -------------------------------------------------------

    def analyze_staged(self, fn: ast.AST, module: ModuleInfo,
                       static_params: frozenset[str] = frozenset()
                       ) -> list[TaintFinding]:
        params = [] if isinstance(fn, ast.With) else _param_names(fn)
        tainted = {p for p in params if p not in static_params}
        self._run(fn, module, _Scope(tainted), depth=0)
        return self.findings

    # -- function body walk -------------------------------------------------

    def _run(self, fn: ast.AST, module: ModuleInfo, scope: _Scope,
             depth: int) -> bool:
        """Walk `fn`'s body under `scope`; returns `returns_tainted`."""
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        if not isinstance(fn.body, list):  # lambda
            return self._expr(fn.body, module, scope, depth)
        # propagate assignments to a fixpoint (loops feed back), then one
        # reporting pass
        for _ in range(4):
            before = set(scope.tainted)
            self._block(body, module, scope, depth, report=False)
            if scope.tainted == before:
                break
        return self._block(body, module, scope, depth, report=True)

    def _block(self, stmts: list, module: ModuleInfo, scope: _Scope,
               depth: int, report: bool) -> bool:
        returns_tainted = False
        for stmt in stmts:
            returns_tainted |= self._stmt(stmt, module, scope, depth,
                                          report)
        return returns_tainted

    def _stmt(self, stmt: ast.stmt, module: ModuleInfo, scope: _Scope,
              depth: int, report: bool) -> bool:
        rt = False
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = stmt.value
            t = self._expr(value, module, scope, depth,
                           report=report) if value is not None else False
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            if isinstance(stmt, ast.AugAssign):
                t = t or self._expr(stmt.target, module, scope, depth,
                                    report=False)
            for tgt in targets:
                for name in _target_names(tgt):
                    if t:
                        scope.tainted.add(name)
                    elif name in scope.tainted and \
                            isinstance(stmt, ast.Assign):
                        scope.tainted.discard(name)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                rt = self._expr(stmt.value, module, scope, depth,
                                report=report)
        elif isinstance(stmt, ast.Expr):
            self._expr(stmt.value, module, scope, depth, report=report)
        elif isinstance(stmt, ast.If):
            if self._expr(stmt.test, module, scope, depth,
                          report=False) and report:
                self._flag(module, stmt, "branch",
                           "Python `if` on a traced value")
            rt |= self._block(stmt.body, module, scope, depth, report)
            rt |= self._block(stmt.orelse, module, scope, depth, report)
        elif isinstance(stmt, ast.While):
            if self._expr(stmt.test, module, scope, depth,
                          report=False) and report:
                self._flag(module, stmt, "branch",
                           "Python `while` on a traced value")
            rt |= self._block(stmt.body, module, scope, depth, report)
            rt |= self._block(stmt.orelse, module, scope, depth, report)
        elif isinstance(stmt, ast.Assert):
            if self._expr(stmt.test, module, scope, depth,
                          report=False) and report:
                self._flag(module, stmt, "assert",
                           "`assert` on a traced value")
        elif isinstance(stmt, ast.For):
            t = self._expr(stmt.iter, module, scope, depth, report=report)
            for name in _target_names(stmt.target):
                if t:
                    scope.tainted.add(name)
            rt |= self._block(stmt.body, module, scope, depth, report)
            rt |= self._block(stmt.orelse, module, scope, depth, report)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                self._expr(item.context_expr, module, scope, depth,
                           report=report)
            rt |= self._block(stmt.body, module, scope, depth, report)
        elif isinstance(stmt, ast.Try):
            rt |= self._block(stmt.body, module, scope, depth, report)
            for h in stmt.handlers:
                rt |= self._block(h.body, module, scope, depth, report)
            rt |= self._block(stmt.finalbody, module, scope, depth, report)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef, ast.Import, ast.ImportFrom,
                               ast.Pass, ast.Break, ast.Continue,
                               ast.Global, ast.Nonlocal, ast.Raise,
                               ast.Delete)):
            pass
        else:
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._expr(child, module, scope, depth, report=report)
        return rt

    # -- expression taint ---------------------------------------------------

    def _expr(self, node: ast.expr, module: ModuleInfo, scope: _Scope,
              depth: int, report: bool = True) -> bool:
        if isinstance(node, ast.Name):
            return scope.is_tainted(node.id)
        if isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Attribute):
            base = self._expr(node.value, module, scope, depth, report)
            if node.attr in _SHAPE_ATTRS:
                return False
            return base
        if isinstance(node, ast.Subscript):
            return self._expr(node.value, module, scope, depth, report) \
                or self._expr(node.slice, module, scope, depth, report)
        if isinstance(node, ast.Call):
            return self._call(node, module, scope, depth, report)
        if isinstance(node, ast.IfExp):
            if self._expr(node.test, module, scope, depth,
                          report=False) and report:
                self._flag(module, node, "branch",
                           "conditional expression on a traced value")
            return self._expr(node.body, module, scope, depth, report) or \
                self._expr(node.orelse, module, scope, depth, report)
        if isinstance(node, (ast.BinOp, ast.BoolOp, ast.Compare,
                             ast.UnaryOp, ast.Tuple, ast.List, ast.Set,
                             ast.Slice, ast.Starred, ast.JoinedStr,
                             ast.FormattedValue, ast.Dict)):
            return any(self._expr(c, module, scope, depth, report)
                       for c in ast.iter_child_nodes(node)
                       if isinstance(c, ast.expr))
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            sub = _Scope(set(), parent=scope)
            for gen in node.generators:
                t = self._expr(gen.iter, module, sub, depth, report)
                for name in _target_names(gen.target):
                    if t:
                        sub.tainted.add(name)
                for cond in gen.ifs:
                    if self._expr(cond, module, sub, depth,
                                  report=False) and report:
                        self._flag(module, cond, "branch",
                                   "comprehension filter on a traced "
                                   "value")
            parts = [node.elt] if not isinstance(node, ast.DictComp) \
                else [node.key, node.value]
            return any(self._expr(p, module, sub, depth, report)
                       for p in parts)
        if isinstance(node, ast.Lambda):
            return False
        return False

    def _call(self, node: ast.Call, module: ModuleInfo, scope: _Scope,
              depth: int, report: bool) -> bool:
        arg_taints = [self._expr(a, module, scope, depth, report)
                      for a in node.args]
        kw_taints = {k.arg: self._expr(k.value, module, scope, depth,
                                       report)
                     for k in node.keywords if k.arg}
        any_tainted = any(arg_taints) or any(kw_taints.values())
        func = node.func

        # method calls -------------------------------------------------
        if isinstance(func, ast.Attribute):
            base_tainted = self._expr(func.value, module, scope, depth,
                                      report=False)
            parts = dotted(func)
            fqn = None
            if parts is not None:
                fqn = self.index.resolve(module, ".".join(parts)) or \
                    _alias_fqn(module, parts)
            if fqn:
                if _is_traced(fqn):
                    return True
                if _is_numpy(fqn) and any_tainted:
                    if report:
                        self._flag(module, node, "materialize",
                                   f"`{'.'.join(parts)}` materializes a "
                                   "traced value on the host")
                    return False
                owner, fndef = self.index.lookup_function(fqn)
                if fndef is not None and owner is not None:
                    return self._inter(node, fndef, owner, arg_taints,
                                       kw_taints, depth, report)
            if func.attr in _SHAPE_METHODS:
                return False
            if base_tainted and func.attr in _MATERIALIZE_METHODS:
                if report:
                    self._flag(module, node, "materialize",
                               f"`.{func.attr}()` materializes a traced "
                               "value on the host")
                return False
            return base_tainted or any_tainted

        # plain-name calls ---------------------------------------------
        if isinstance(func, ast.Name):
            name = func.id
            if name in _MATERIALIZE_BUILTINS and any_tainted:
                if report:
                    self._flag(module, node, "materialize",
                               f"`{name}()` forces a traced value to a "
                               "host scalar")
                return False
            if name in _HOST_CALLS and any_tainted:
                if report:
                    self._flag(module, node, "host",
                               f"`{name}()` is a host side effect on a "
                               "traced value")
                return False
            if name in _UNTAINT_BUILTINS:
                return False
            fqn = self.index.resolve(module, name)
            if fqn:
                if _is_traced(fqn):
                    return True
                owner, fndef = self.index.lookup_function(fqn)
                if fndef is not None and owner is not None:
                    return self._inter(node, fndef, owner, arg_taints,
                                       kw_taints, depth, report)
            return any_tainted
        # computed callee (lambda var, functools.partial result, ...)
        self._expr(func, module, scope, depth, report=False)
        return any_tainted

    # -- interprocedural ----------------------------------------------------

    def _inter(self, call: ast.Call, fn: ast.AST, owner: ModuleInfo,
               arg_taints: list[bool], kw_taints: dict, depth: int,
               report: bool) -> bool:
        if depth >= self.max_depth:
            return any(arg_taints) or any(kw_taints.values())
        params = _param_names(fn)
        tainted = set()
        for i, t in enumerate(arg_taints):
            if t and i < len(params):
                tainted.add(params[i])
        for k, t in kw_taints.items():
            if t and k in params:
                tainted.add(k)
        key = (owner.name, getattr(fn, "name", "<lambda>"),
               getattr(fn, "lineno", 0), frozenset(tainted), report)
        if key in self._memo:
            return self._memo[key]
        if key in self._active:       # recursion: assume propagation
            return bool(tainted)
        self._active.add(key)
        try:
            rt = self._run(fn, owner, _Scope(tainted), depth + 1)
        finally:
            self._active.discard(key)
        self._memo[key] = rt
        return rt

    # -- helpers ------------------------------------------------------------

    def _flag(self, module: ModuleInfo, node: ast.AST, kind: str,
              detail: str) -> None:
        f = TaintFinding(module, node, kind, detail)
        # dedupe on (module, line, kind)
        sig = (module.name, getattr(node, "lineno", 0), kind)
        if sig not in {(x.module.name, getattr(x.node, "lineno", 0),
                        x.kind) for x in self.findings}:
            self.findings.append(f)


def _is_traced(fqn: str) -> bool:
    """A torch call's result inside a staged body is a traced tensor."""
    return fqn == "torch" or fqn.startswith("torch.")


def _is_numpy(fqn: str) -> bool:
    return fqn == "numpy" or fqn.startswith("numpy.")


def _alias_fqn(module: ModuleInfo, parts: list[str]) -> Optional[str]:
    head = module.imports.get(parts[0])
    if head is None:
        return None
    return ".".join([head] + parts[1:])


def _param_names(fn: ast.AST) -> list[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def _target_names(tgt: ast.expr) -> list[str]:
    out = []
    for n in ast.walk(tgt):
        if isinstance(n, ast.Name):
            out.append(n.id)
    return out

"""tracer-taint: interprocedural staging purity through the taint engine.

``jit-purity`` pattern-matches the staged body itself (host numpy calls,
``print``, bare ``if param:``).  This rule runs
:class:`repro_torch.analysis.flow.taint.TaintAnalyzer` over every function
staged into a torch staging call (``torch.compile``, ``torch.jit``,
``torch.func.vmap`` / ``grad``) and every ``torch.cuda.graph`` capture
body outside tests: parameters and ``torch.*`` results are traced, taint
flows through locals *and into project helpers called from the staged
body*, and any Python ``if``/``while``/``assert``/comprehension-filter on
a tainted expression, host materialization (``np.asarray``, ``float()``,
``.item()``, ``.numpy()``), or host side effect on a tainted value is
reported at its source line — including lines in a helper module the
syntactic rule never looks at.

Arguments that ``torch.func.vmap`` passes through (``None`` in its
``in_dims``) are seeded untainted (they really are Python values there).
"""
from __future__ import annotations

import ast

from .. import ProgramContext, register_rule
from ..flow.taint import TaintAnalyzer
from ._util import import_aliases, resolve
from .purity import _JIT_ENTRY, _jitted_functions

_KIND_HINTS = {
    "branch": "use torch.where / torch.cond, or pass the driving value "
              "as a Python value",
    "assert": "validate before staging; `assert` on a traced tensor "
              "breaks the graph",
    "materialize": "stay in torch ops inside staged bodies; materializing "
                   "a traced tensor breaks the graph (or freezes a "
                   "trace-time constant)",
    "host": "hoist the side effect out of the staged body",
}


def _static_params(tree: ast.AST, fn: ast.AST,
                   aliases: dict[str, str]) -> frozenset[str]:
    """Parameter names that stay Python values at this function's staging
    sites: a ``None`` in ``torch.func.vmap``'s ``in_dims`` (the argument is
    not batched, so it is passed through as given)."""
    if isinstance(fn, ast.With):
        return frozenset()
    names = _param_list(fn)
    static: set[str] = set()
    fname = getattr(fn, "name", None)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        full = resolve(node.func, aliases)
        if full not in _JIT_ENTRY:
            continue
        hits = fname is not None and any(
            isinstance(a, ast.Name) and a.id == fname
            for a in node.args)
        if not hits:
            continue
        for kw in node.keywords:
            if kw.arg == "in_dims" and isinstance(kw.value, ast.Tuple):
                for i, el in enumerate(kw.value.elts):
                    if isinstance(el, ast.Constant) and el.value is None \
                            and i < len(names):
                        static.add(names[i])
    return frozenset(static)


def _param_list(fn: ast.AST) -> list[str]:
    a = fn.args
    return [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]


@register_rule("tracer-taint",
               "taint tracking through torch's staged bodies: no Python "
               "control "
               "flow, materialization, or host effects on traced values — "
               "interprocedurally",
               scope="program")
def _tracer_taint(ctx: ProgramContext):
    index = ctx.index
    by_module = {mi.name: fc for fc in ctx.files
                 for mi in [index.by_rel.get(fc.rel)] if mi is not None}
    seen: set[tuple] = set()
    for fc in ctx.files:
        if fc.in_testing():
            continue
        mi = index.by_rel.get(fc.rel)
        if mi is None:
            continue
        aliases = import_aliases(fc.tree)
        for fn, via in _jitted_functions(fc.tree, aliases):
            analyzer = TaintAnalyzer(index)
            static = _static_params(fc.tree, fn, aliases)
            try:
                found = analyzer.analyze_staged(fn, mi, static)
            except RecursionError:
                continue
            name = getattr(fn, "name", "<lambda>")
            for f in found:
                line = getattr(f.node, "lineno", 1)
                sig = (f.module.name, line, f.kind)
                if sig in seen:
                    continue
                seen.add(sig)
                target = by_module.get(f.module.name, fc)
                where = "" if f.module is mi else \
                    f" (reached from {name}() staged into {via})"
                yield target.finding(
                    "tracer-taint", f.node,
                    f"{f.detail} inside a staged body{where}",
                    _KIND_HINTS.get(f.kind, ""))

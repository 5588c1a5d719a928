"""jit-purity: a function handed to one of torch's staging calls —
``torch.compile``, ``torch.jit.script`` / ``torch.jit.trace``,
``torch.func.vmap`` / ``torch.vmap``, ``torch.func.grad`` — or a body
captured by ``with torch.cuda.graph(g):`` runs as a traced or recorded
program: host-side numpy calls freeze trace-time values, prints fire once
per trace (not per step), closed-over mutation desynchronizes replays, and
``if tensor:`` breaks the graph (or bakes one branch into it) on the
inputs that reach it.  A card's result equal to the CPU's depends on every
staged body being pure.  The port stages nothing today; the rule keeps it
so, outside tests."""
from __future__ import annotations

import ast

from .. import FileContext, register_rule
from ._util import import_aliases, iter_scope, local_names, param_names, \
    resolve

_JIT_ENTRY = {"torch.compile", "torch.jit.script", "torch.jit.trace",
              "torch.func.vmap", "torch.vmap", "torch.func.grad",
              "torch.func.grad_and_value", "torch.func.jacrev",
              "torch.func.jacfwd", "torch.func.functional_call"}
_CAPTURE = {"torch.cuda.graph", "torch.cuda.graphs.graph"}

# host-only numpy attributes that are pure trace-time constants — calling
# them inside a staged body is deliberate staging, not a leak
_PURE_NP = {"iinfo", "finfo", "dtype"}


def _jitted_functions(tree, aliases):
    """(node, via) for every FunctionDef/Lambda staged into a torch staging
    call, and every ``with torch.cuda.graph(...)`` capture (the With)."""
    defs = {n.name: n for n in ast.walk(tree)
            if isinstance(n, ast.FunctionDef)}
    out: dict[int, tuple[ast.AST, str]] = {}

    def add(node, via):
        out.setdefault(id(node), (node, via))

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            full = resolve(node.func, aliases)
            if full in _JIT_ENTRY:
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    if isinstance(arg, ast.Lambda):
                        add(arg, full)
                    elif isinstance(arg, ast.Name) and arg.id in defs:
                        add(defs[arg.id], full)
        elif isinstance(node, ast.FunctionDef):
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                full = resolve(target, aliases)
                if full in _JIT_ENTRY:
                    add(node, full)
                elif full in ("functools.partial", "partial") and \
                        isinstance(dec, ast.Call):
                    if any(resolve(a, aliases) in _JIT_ENTRY
                           for a in dec.args):
                        add(node, "torch.compile")
        elif isinstance(node, ast.With):
            for item in node.items:
                expr = item.context_expr
                target = expr.func if isinstance(expr, ast.Call) else expr
                full = resolve(target, aliases)
                if full in _CAPTURE:
                    add(node, full)
    return out.values()


@register_rule("jit-purity",
               "functions staged into torch.compile/torch.jit/torch.func."
               "vmap/grad (and torch.cuda.graph captures) must not call "
               "numpy, print, mutate closed-over state, or branch on tensor "
               "truthiness")
def _jit_purity(ctx: FileContext):
    if ctx.in_testing():
        return
    aliases = import_aliases(ctx.tree)
    for fn, via in _jitted_functions(ctx.tree, aliases):
        if isinstance(fn, ast.With):
            # a capture body: its names are the enclosing scope's own
            name, params = "<graph capture>", set()
            locs = {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)}
            body = fn.body
        else:
            name = getattr(fn, "name", "<lambda>")
            locs = local_names(fn)
            params = param_names(fn)
            body = fn.body if isinstance(fn.body, list) else [fn.body]
        for stmt in body:
            for node in [stmt, *iter_scope(stmt)]:
                yield from _check_node(ctx, node, name, via, locs, params,
                                       aliases)


def _check_node(ctx, node, name, via, locs, params, aliases):
    if isinstance(node, ast.Call):
        full = resolve(node.func, aliases)
        if full and full.split(".")[0] == "numpy":
            attr = full.split(".")[-1]
            if attr not in _PURE_NP:
                yield ctx.finding(
                    "jit-purity", node,
                    f"{name}() is staged into {via} but calls host "
                    f"numpy ({full})",
                    "use torch ops inside staged bodies; host numpy "
                    "freezes trace-time values")
        elif full == "print":
            yield ctx.finding(
                "jit-purity", node,
                f"{name}() is staged into {via} but calls print()",
                "log outside the staged body")
    elif isinstance(node, (ast.Global, ast.Nonlocal)):
        yield ctx.finding(
            "jit-purity", node,
            f"{name}() is staged into {via} but declares "
            f"{'global' if isinstance(node, ast.Global) else 'nonlocal'} "
            f"{', '.join(node.names)}",
            "return state instead of mutating closures")
    elif isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            root = t
            while isinstance(root, (ast.Attribute, ast.Subscript)):
                root = root.value
            if isinstance(root, ast.Name) and root.id not in locs \
                    and root is not t:
                yield ctx.finding(
                    "jit-purity", node,
                    f"{name}() is staged into {via} but mutates "
                    f"closed-over state ({root.id})",
                    "return updated values; staged bodies must be pure")
    elif isinstance(node, (ast.If, ast.While)):
        test = node.test
        bare = test.id if isinstance(test, ast.Name) else (
            test.operand.id if isinstance(test, ast.UnaryOp)
            and isinstance(test.op, ast.Not)
            and isinstance(test.operand, ast.Name) else None)
        if bare is not None and bare in params:
            yield ctx.finding(
                "jit-purity", node,
                f"{name}() is staged into {via} but branches on the "
                f"truthiness of traced argument {bare!r}",
                "use torch.where / torch.cond, or pass a Python value")

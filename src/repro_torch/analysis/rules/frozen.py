"""frozen-core-types: ``Instance`` (``repro_torch/core/types.py``),
``Transcript`` (``core/result.py``), and ``FinalSchedule``
(``core/timeline.py``) are the
currency the equivalence matrix compares bit-for-bit — once constructed
they are read-only everywhere except their defining modules (which own
legitimate in-place construction like ``sched.ledger.append``)."""
from __future__ import annotations

import ast

from .. import FileContext, register_rule
from ._util import dotted, func_scopes, iter_scope

_FROZEN = {
    "Instance": "repro_torch/core/types.py",
    "Transcript": "repro_torch/core/result.py",
    "FinalSchedule": "repro_torch/core/timeline.py",
}

_MUTATORS = {"append", "extend", "insert", "remove", "pop", "clear",
             "sort", "reverse", "update", "setdefault", "add", "discard"}

_HINT = ("treat core result types as immutable outside their defining "
         "module: build a new instance (dataclasses.replace) or do the "
         "mutation where the type is defined")


def _ann_type(node: ast.AST | None) -> str | None:
    """Frozen-type name mentioned in an annotation, if any."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        for t in _FROZEN:
            if t in node.value:
                return t
    for n in ast.walk(node):
        nm = None
        if isinstance(n, ast.Name):
            nm = n.id
        elif isinstance(n, ast.Attribute):
            nm = n.attr
        if nm in _FROZEN:
            return nm
    return None


def _tracked_in(scope: ast.AST, exempt: set[str]) -> dict[str, str]:
    """var name -> frozen type for this scope (constructor calls and
    annotations), skipping types whose defining module this file is."""
    tracked: dict[str, str] = {}

    def note(name: str, typ: str | None):
        if typ and typ not in exempt:
            tracked[name] = typ

    if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
        a = scope.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            note(p.arg, _ann_type(p.annotation))
    for node in [scope, *iter_scope(scope)]:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                isinstance(node.value, ast.Call):
            parts = dotted(node.value.func)
            if parts and parts[-1] in _FROZEN:
                note(node.targets[0].id, parts[-1])
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            note(node.target.id, _ann_type(node.annotation))
    return tracked


@register_rule("frozen-core-types",
               "no attribute assignment or in-place mutation on Instance/"
               "Transcript/FinalSchedule outside their defining modules")
def _frozen_core_types(ctx: FileContext):
    if ctx.in_testing():
        return
    exempt = {t for t, mod in _FROZEN.items() if ctx.rel.endswith(mod)}
    if len(exempt) == len(_FROZEN):
        return
    scopes: list[ast.AST] = [ctx.tree, *func_scopes(ctx.tree)]
    for scope in scopes:
        tracked = _tracked_in(scope, exempt)
        if not tracked:
            continue
        yield from _check_scope(ctx, scope, tracked)


def _check_scope(ctx, scope, tracked):
    for node in [scope, *iter_scope(scope)]:
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                root = t
                while isinstance(root, (ast.Attribute, ast.Subscript)):
                    root = root.value
                if isinstance(root, ast.Name) and root.id in tracked \
                        and root is not t:
                    yield ctx.finding(
                        "frozen-core-types", node,
                        f"assignment into frozen {tracked[root.id]} "
                        f"instance {root.id!r}", _HINT)
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _MUTATORS:
            parts = dotted(node.func)
            if parts and len(parts) >= 3 and parts[0] in tracked:
                yield ctx.finding(
                    "frozen-core-types", node,
                    f"in-place {parts[-1]}() on frozen "
                    f"{tracked[parts[0]]} instance {parts[0]!r}", _HINT)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                root = t
                while isinstance(root, (ast.Attribute, ast.Subscript)):
                    root = root.value
                if isinstance(root, ast.Name) and root.id in tracked \
                        and root is not t:
                    yield ctx.finding(
                        "frozen-core-types", node,
                        f"del on frozen {tracked[root.id]} instance "
                        f"{root.id!r}", _HINT)

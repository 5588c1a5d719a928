"""Shared AST helpers for the rules: import-alias resolution and dotted
attribute-chain flattening, so checks can match ``np.random.seed`` no
matter how numpy was imported."""
from __future__ import annotations

import ast
from typing import Iterator


def import_aliases(tree: ast.AST) -> dict[str, str]:
    """Local binding -> dotted module/object path for every import in the
    module (``import numpy as np`` -> {"np": "numpy"}; ``from numpy import
    random as nr`` -> {"nr": "numpy.random"}; relative imports are prefixed
    with one dot per level)."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    aliases[a.asname] = a.name
                else:
                    root = a.name.split(".")[0]
                    aliases[root] = root
        elif isinstance(node, ast.ImportFrom):
            base = "." * node.level + (node.module or "")
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = (f"{base}.{a.name}" if base
                                               else a.name)
    return aliases


def dotted(node: ast.AST) -> list[str] | None:
    """["np", "random", "seed"] for the expression ``np.random.seed``;
    None when the chain is not rooted in a plain Name."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return None


def resolve(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """Alias-expanded dotted name of an expression, e.g. ``np.random.seed``
    -> "numpy.random.seed" under ``import numpy as np``."""
    parts = dotted(node)
    if parts is None:
        return None
    head = aliases.get(parts[0], parts[0])
    return ".".join([head] + parts[1:])


_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                ast.ClassDef)


def iter_scope(node: ast.AST) -> Iterator[ast.AST]:
    """Walk `node`'s subtree without descending into nested function/class
    scopes (the nested scopes are analyzed separately)."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, _SCOPE_NODES):
            continue
        yield child
        yield from iter_scope(child)


def func_scopes(tree: ast.AST) -> Iterator[ast.FunctionDef]:
    """Every (async) function definition in the module, at any nesting."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def param_names(fn: ast.FunctionDef | ast.Lambda) -> set[str]:
    a = fn.args
    names = {p.arg for p in
             (a.posonlyargs + a.args + a.kwonlyargs)}
    if a.vararg:
        names.add(a.vararg.arg)
    if a.kwarg:
        names.add(a.kwarg.arg)
    return names


def local_names(fn: ast.FunctionDef | ast.Lambda) -> set[str]:
    """Params plus every plain-Name binding inside the function (at any
    nesting — good enough for "is this base object local" checks)."""
    names = param_names(fn)
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name) and isinstance(
                    node.ctx, (ast.Store, ast.Del)):
                names.add(node.id)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Lambda)):
                names |= param_names(node)
            elif isinstance(node, ast.comprehension):
                for t in ast.walk(node.target):
                    if isinstance(t, ast.Name):
                        names.add(t.id)
    return names

"""Project call graph + configuration-knob read scanning.

Built on :class:`~repro_torch.analysis.flow.modules.ProjectIndex`: for every
scanned function we record the set of *resolved* callee FQNs (dotted
names resolved through import aliases and re-exports to their defining
module).  ``reachable`` runs a bounded BFS over that edge set — the
cache-key rule walks it from a cached value's producer to find
environment / config reads that can influence the value without being
part of the cache key.

A "knob read" is either:

* ``os.environ[...]``, ``os.environ.get(...)`` or ``os.getenv(...)`` —
  raw environment access, whatever the key (the port has no ``REPRO_*``
  knobs: dispatch is by device, so any environment read is a hidden
  input), or
* an attribute read off a name that resolves to a ``*config`` object
  (``<module>.config.<attr>``) — the structured form of a knob.
"""
from __future__ import annotations

import ast
from typing import Iterable, Optional

from .modules import ModuleInfo, ProjectIndex, dotted

__all__ = ["CallGraph", "KnobRead", "find_knob_reads"]


class KnobRead:
    """One configuration read inside a function body."""

    __slots__ = ("kind", "name", "line")

    def __init__(self, kind: str, name: str, line: int):
        self.kind = kind    # "env" | "config"
        self.name = name    # the variable (or "?") or the config attribute
        self.line = line

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"KnobRead({self.kind}:{self.name}@{self.line})"


def find_knob_reads(fn: ast.AST, mi: ModuleInfo,
                    index: ProjectIndex) -> list[KnobRead]:
    """All env-var / config-attribute reads lexically inside `fn`."""
    out: list[KnobRead] = []
    for node in ast.walk(fn):
        # os.environ[K], os.environ.get(K, ...) and os.getenv(K, ...)
        key: Optional[ast.expr] = None
        target: Optional[ast.expr] = None
        if isinstance(node, ast.Subscript):
            target, key = node.value, node.slice
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "get" and node.args:
            target, key = node.func.value, node.args[0]
        if target is not None and _is_environ(target, mi, index):
            out.append(KnobRead("env", _key_name(key), node.lineno))
            continue
        if isinstance(node, ast.Call) and _is_getenv(node.func, mi, index):
            out.append(KnobRead("env", _key_name(
                node.args[0] if node.args else None), node.lineno))
            continue
        # config.<attr> where `config` resolves to a *config binding
        if isinstance(node, ast.Attribute) and \
                isinstance(node.ctx, ast.Load) and \
                not node.attr.startswith("_"):
            parts = dotted(node.value)
            if parts is None:
                continue
            fqn = index.resolve(mi, ".".join(parts)) or ".".join(parts)
            if fqn.split(".")[-1] in ("config", "CONFIG"):
                out.append(KnobRead("config", node.attr, node.lineno))
    return out


def _key_name(key: Optional[ast.expr]) -> str:
    if isinstance(key, ast.Constant) and isinstance(key.value, str):
        return key.value
    return "?"


def _is_environ(expr: ast.expr, mi: ModuleInfo,
                index: ProjectIndex) -> bool:
    parts = dotted(expr)
    if parts is None:
        return False
    fqn = index.resolve(mi, ".".join(parts)) or ".".join(parts)
    return fqn in ("os.environ", "environ")


def _is_getenv(func: ast.expr, mi: ModuleInfo, index: ProjectIndex) -> bool:
    parts = dotted(func)
    if parts is None:
        return False
    fqn = index.resolve(mi, ".".join(parts)) or ".".join(parts)
    return fqn in ("os.getenv", "getenv")


class CallGraph:
    """Resolved call edges between scanned functions."""

    def __init__(self, index: ProjectIndex):
        self.index = index
        self._edges: dict[str, set[str]] = {}

    def _fqn(self, mi: ModuleInfo, name: str) -> str:
        return f"{mi.name}.{name}"

    def callees(self, fqn: str) -> set[str]:
        """Resolved FQNs called from `fqn`'s body (computed lazily)."""
        if fqn in self._edges:
            return self._edges[fqn]
        owner, fn = self.index.lookup_function(fqn)
        edges: set[str] = set()
        self._edges[fqn] = edges
        if owner is None or fn is None:
            return edges
        local_fns = {n.name for n in ast.walk(fn)
                     if isinstance(n, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))
                     and n is not fn}
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            parts = dotted(node.func)
            if parts is None:
                continue
            if parts[0] in local_fns:
                # nested helper: analyze inline under the same module
                edges.add(self._fqn(owner, parts[0]))
                continue
            resolved = self.index.resolve(owner, ".".join(parts))
            if resolved is None:
                continue
            ro, rf = self.index.lookup_function(resolved)
            if ro is not None and rf is not None:
                edges.add(f"{ro.name}.{rf.name}")
        return edges

    def reachable(self, roots: Iterable[str], max_depth: int = 6,
                  stop: Optional[set[str]] = None) -> set[str]:
        """Functions reachable from `roots` (inclusive), bounded BFS.

        `stop` names are included when reached but not traversed — used
        for certified-neutral dispatch helpers whose internals are
        audited out-of-band (the bit-identity tests).
        """
        stop = stop or set()
        seen: set[str] = set()
        frontier = [(r, 0) for r in roots]
        while frontier:
            fqn, d = frontier.pop()
            if fqn in seen or d > max_depth:
                continue
            seen.add(fqn)
            if fqn in stop:
                continue
            for callee in self.callees(fqn):
                if callee not in seen:
                    frontier.append((callee, d + 1))
        return seen

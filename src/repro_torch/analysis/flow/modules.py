"""Module and symbol resolution over a scanned file set.

The program-scope rules need to answer "what does this dotted name refer
to, project-wide?" — ``from ..coflow_merge.ref import build_delta`` inside
``repro_torch/kernels/merge_fix/ops.py`` must resolve to the *function object's*
defining module so the interval engine can evaluate its body under that
module's own import aliases.  :class:`ProjectIndex` builds that map from
the scanned :class:`~repro_torch.analysis.FileContext` list alone (no imports
are executed): path -> dotted module name, per-module symbol tables
(functions at any nesting, top-level constants, import bindings resolved
to absolute dotted targets), and a chased :meth:`resolve` /
:meth:`lookup_function`.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .. import FileContext

__all__ = ["dotted", "module_name_for", "ModuleInfo", "ProjectIndex"]


def dotted(node: ast.AST) -> list[str] | None:
    """["np", "random", "seed"] for the expression ``np.random.seed``;
    None when the chain is not rooted in a plain Name.  (Mirror of
    ``rules._util.dotted``, defined here so the flow package never
    imports the rules package — rules import flow, not the reverse.)"""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return None


def module_name_for(rel: str) -> str:
    """Dotted module name for a scan-root-relative path.

    ``src/repro_torch/core/backend.py`` -> ``repro_torch.core.backend``;
    ``benchmarks/run.py`` -> ``benchmarks.run``; ``pkg/__init__.py`` ->
    ``pkg``.  The leading ``src/`` layout component is dropped so fixture
    trees and the real repo resolve identically.
    """
    parts = rel.split("/")
    if parts and parts[0] == "src":
        parts = parts[1:]
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][: -len(".py")]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(p for p in parts if p)


@dataclass
class ModuleInfo:
    """One scanned module: its context plus symbol tables."""

    name: str                       # dotted module name
    ctx: "FileContext"
    is_package: bool
    functions: dict[str, ast.FunctionDef] = field(default_factory=dict)
    classes: dict[str, ast.ClassDef] = field(default_factory=dict)
    imports: dict[str, str] = field(default_factory=dict)  # local -> absolute
    constants: dict[str, ast.expr] = field(default_factory=dict)

    @property
    def package(self) -> str:
        """The package this module's relative imports anchor on."""
        if self.is_package:
            return self.name
        return self.name.rsplit(".", 1)[0] if "." in self.name else ""


def _index_module(mi: ModuleInfo) -> None:
    tree = mi.ctx.tree
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # top-level name wins; nested defs index under their own name
            # only if unclaimed (good enough for helper resolution)
            mi.functions.setdefault(node.name, node)
        elif isinstance(node, ast.ClassDef):
            mi.classes.setdefault(node.name, node)
        elif isinstance(node, ast.Import):
            # function-level imports included: the repo lazily imports
            # inside functions to break cycles, and interprocedural
            # resolution must see those bindings (first binding wins)
            for a in node.names:
                if a.asname:
                    mi.imports.setdefault(a.asname, a.name)
                else:
                    root = a.name.split(".")[0]
                    mi.imports.setdefault(root, root)
        elif isinstance(node, ast.ImportFrom):
            base = _absolute_base(mi, node)
            if base is None:
                continue
            for a in node.names:
                if a.name == "*":
                    continue
                target = f"{base}.{a.name}" if base else a.name
                mi.imports.setdefault(a.asname or a.name, target)
    for node in tree.body if isinstance(tree, ast.Module) else []:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            mi.constants[node.targets[0].id] = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None and \
                isinstance(node.target, ast.Name):
            mi.constants[node.target.id] = node.value


def _absolute_base(mi: ModuleInfo, node: ast.ImportFrom) -> str | None:
    """Absolute dotted base for an ImportFrom (relative levels resolved
    against the module's package)."""
    if node.level == 0:
        return node.module or ""
    anchor = mi.package.split(".") if mi.package else []
    drop = node.level - 1
    if drop > len(anchor):
        return None
    anchor = anchor[: len(anchor) - drop]
    if node.module:
        anchor += node.module.split(".")
    return ".".join(anchor)


class ProjectIndex:
    """Whole-program symbol table over the scanned files."""

    def __init__(self, files: "list[FileContext]"):
        self.modules: dict[str, ModuleInfo] = {}
        self.by_rel: dict[str, ModuleInfo] = {}
        for ctx in files:
            name = module_name_for(ctx.rel)
            if not name:
                continue
            mi = ModuleInfo(name, ctx,
                            is_package=ctx.rel.endswith("__init__.py"))
            _index_module(mi)
            self.modules[name] = mi
            self.by_rel[ctx.rel] = mi

    # --- resolution -------------------------------------------------------

    def resolve(self, mi: ModuleInfo, dotted: str,
                _depth: int = 0) -> str | None:
        """Absolute dotted target of `dotted` as seen from module `mi`:
        import aliases expanded and re-exports chased (bounded)."""
        if _depth > 6:
            return None
        parts = dotted.split(".")
        head = mi.imports.get(parts[0])
        if head is None:
            if parts[0] in mi.functions or parts[0] in mi.classes or \
                    parts[0] in mi.constants:
                return f"{mi.name}.{dotted}"
            return None
        fqn = ".".join([head] + parts[1:])
        # chase one re-export level: if fqn's module prefix is an indexed
        # module that merely imports the tail, follow it
        owner, tail = self.split(fqn)
        if owner is not None and tail and "." not in tail and \
                tail not in owner.functions and tail not in owner.classes \
                and tail not in owner.constants and tail in owner.imports:
            return self.resolve(owner, tail, _depth + 1)
        return fqn

    def split(self, fqn: str) -> tuple[Optional[ModuleInfo], str]:
        """(owning module, remainder qualname) for an absolute dotted name
        — the longest indexed module prefix wins."""
        parts = fqn.split(".")
        for i in range(len(parts), 0, -1):
            name = ".".join(parts[:i])
            if name in self.modules:
                return self.modules[name], ".".join(parts[i:])
        return None, fqn

    def lookup_function(
        self, fqn: str | None
    ) -> tuple[Optional[ModuleInfo], Optional[ast.FunctionDef]]:
        """(module, FunctionDef) for an absolute dotted name, or (None,
        None) when it is not a scanned function."""
        if not fqn:
            return None, None
        owner, tail = self.split(fqn)
        if owner is None or not tail:
            return None, None
        fn = owner.functions.get(tail)
        if fn is not None:
            return owner, fn
        # plain re-export (from .impl import f) — chase it
        if tail in owner.imports:
            return self.lookup_function(owner.imports[tail])
        return None, None

    def lookup_constant(
        self, fqn: str | None
    ) -> tuple[Optional[ModuleInfo], Optional[ast.expr]]:
        if not fqn:
            return None, None
        owner, tail = self.split(fqn)
        if owner is None or not tail:
            return None, None
        if tail in owner.constants:
            return owner, owner.constants[tail]
        if tail in owner.imports:
            return self.lookup_constant(owner.imports[tail])
        return None, None

"""backend-dispatch: kernel implementations are reached only through the
``core/backend.py`` dispatch layer, so every call site gets the checks,
the dispatch by device and the caches for free.  Imports of
``repro_torch.kernels.<k>`` (a kernel package) and of the build helpers
``load_kernel`` / ``build_kernels`` are allowed only in the dispatch layer
itself, the pipeline, the kernel packages, tests, and benchmarks.

Relative imports are resolved against the file's package, so ``from
..kernels.flash_attention import ops`` inside ``repro_torch/models/`` is
the same import as its absolute spelling.  The package root's
``resolve_device`` is let through: it selects a device (and raises
without a card) and launches nothing, and every entry point calls it."""
from __future__ import annotations

import ast

from .. import FileContext, register_rule

_PKG = "repro_torch.kernels"
_ALLOWED_FILES = ("repro_torch/core/backend.py",
                  "repro_torch/core/pipeline.py")
# names of the package root that reach no kernel
_NEUTRAL = {"resolve_device"}

_HINT = ("call through repro_torch.core.backend (or the core dispatch "
         "wrappers); if this site IS the resolved dispatch target, "
         "annotate it with `# repro: allow(backend-dispatch): <one-line "
         "why>`")


def _allowed(ctx: FileContext) -> bool:
    return (any(ctx.rel.endswith(f) for f in _ALLOWED_FILES)
            or ctx.in_kernels() or ctx.in_testing() or ctx.in_benchmarks())


def _package(rel: str) -> list[str] | None:
    """The dotted package a file's relative imports anchor on
    (``src/repro_torch/models/layers.py`` -> [repro_torch, models])."""
    parts = rel.split("/")
    if parts and parts[0] == "src":
        parts = parts[1:]
    if not parts or not parts[-1].endswith(".py"):
        return None
    return parts[:-1]


def _absolute(ctx: FileContext, node: ast.ImportFrom) -> str | None:
    if node.level == 0:
        return node.module or ""
    pkg = _package(ctx.rel)
    if pkg is None or node.level - 1 > len(pkg):
        return None
    base = pkg[:len(pkg) - (node.level - 1)]
    return ".".join(base + (node.module.split(".") if node.module else []))


def _hits(mod: str, names: list[str]) -> list[str]:
    """The imported names that reach a kernel: a kernel subpackage (or
    anything under one), or a build helper of the package root."""
    if mod.startswith(_PKG + "."):
        return names
    if mod == _PKG:
        return [n for n in names if n not in _NEUTRAL]
    if mod == "repro_torch":
        return [n for n in names if n == "kernels"]
    return []


@register_rule("backend-dispatch",
               "repro_torch.kernels.<k> (and load_kernel/build_kernels) "
               "imported only via core/backend.py dispatch (plus pipeline, "
               "kernel packages, tests, benchmarks); relative imports "
               "resolved")
def _backend_dispatch(ctx: FileContext):
    if _allowed(ctx):
        return
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == _PKG or a.name.startswith(_PKG + "."):
                    yield ctx.finding(
                        "backend-dispatch", node,
                        f"direct import of {a.name} bypasses backend "
                        "dispatch", _HINT)
        elif isinstance(node, ast.ImportFrom):
            mod = _absolute(ctx, node)
            if mod is None:
                continue
            hits = _hits(mod, [a.name for a in node.names])
            if hits:
                yield ctx.finding(
                    "backend-dispatch", node,
                    f"direct import of {', '.join(hits)} from {mod} "
                    "bypasses backend dispatch", _HINT)

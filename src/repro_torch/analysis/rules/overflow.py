"""overflow-guard: the syntactic half of the int32 launch contract.

Every kernel ``ops.py`` of the port hands extents to ``ctypes.c_int``
arguments of its CUDA entry points, and ctypes wraps a Python int that
does not fit a C int without a word (2**31 + 5 arrives as -2147483643,
2**40 as 0).  So each must compare what it launches against the int32
sentinel (``_I32_MAX``, ``np.iinfo(np.int32).max`` or ``2**31 - 1``)
and **raise** past it.  The reference's wrappers may also fall back to
their numpy/jnp reference; the port's may not: a fall-back to the plain
version on a CUDA tensor is the hidden fallback the port's dispatch by
device forbids (``kernels/merge_fix/ops.py::_check_edge_count`` is the
pattern).

This rule is deliberately shallow — "a sentinel-comparing guard that
raises exists, and no sentinel guard escapes to the plain version" — and
is kept as the fast, fixture-friendly first line.  *Sufficiency* (does a
guard dominate every launch, does it cover every ``c_int`` argument and
every operand the kernel indexes in 32 bits on every path) is proven by
the program-scope ``overflow-range`` rule in
:mod:`repro_torch.analysis.rules.overflow_range`, which runs the interval
engine over the same files; a file can pass this rule and still fail
``overflow-range``, and that is the designed split.
"""
from __future__ import annotations

import ast
import re

from .. import FileContext, register_rule

_OPS_RE = re.compile(r"repro_torch/kernels/[^/]+/ops\.py$")
_SENTINEL_NAME = re.compile(r"_?I(?:NT)?_?32_?MAX", re.IGNORECASE)
_I32_MAX = 2**31 - 1

_HINT = ("compare each extent passed at a ctypes.c_int argument (and the "
         "element count of each operand the kernel indexes in 32 bits) "
         "against the int32 sentinel and raise past it "
         "(kernels/merge_fix/ops.py::_check_edge_count); never fall back "
         "to the plain version on a CUDA tensor")


def _mentions_sentinel(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and _SENTINEL_NAME.search(n.id):
            return True
        if isinstance(n, ast.Attribute) and _SENTINEL_NAME.search(n.attr):
            return True
        if isinstance(n, ast.Constant) and n.value == _I32_MAX:
            return True
        if isinstance(n, ast.Call):
            tail = None
            if isinstance(n.func, ast.Attribute):
                tail = n.func.attr
            elif isinstance(n.func, ast.Name):
                tail = n.func.id
            if tail == "iinfo":
                return True
    return False


def _ref_names(tree: ast.AST) -> set[str]:
    """Local names bound by an import from a ``ref`` module (or of one)."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if (node.module or "").split(".")[-1] == "ref":
                out |= {a.asname or a.name for a in node.names}
            else:
                out |= {a.asname or a.name for a in node.names
                        if a.name == "ref"}
        elif isinstance(node, ast.Import):
            out |= {a.asname or a.name.split(".")[0] for a in node.names
                    if a.name.split(".")[-1] == "ref"}
    return out


def _branches(guard: ast.AST) -> list[ast.AST]:
    if isinstance(guard, ast.If):
        return [*guard.body, *guard.orelse]
    return [guard.body, guard.orelse]


def _calls_ref(guard: ast.AST, refs: set[str]) -> bool:
    for branch in _branches(guard):
        for n in ast.walk(branch):
            if isinstance(n, ast.Call):
                root = n.func
                while isinstance(root, ast.Attribute):
                    root = root.value
                if isinstance(root, ast.Name) and root.id in refs:
                    return True
    return False


@register_rule("overflow-guard",
               "kernel ops.py must guard its int32 launch arguments with a "
               "sentinel comparison that raises, never a fall-back to the "
               "plain version (sufficiency is proven separately by "
               "overflow-range)")
def _overflow_guard(ctx: FileContext):
    if not _OPS_RE.search(ctx.rel):
        return
    guards = [node for node in ast.walk(ctx.tree)
              if isinstance(node, (ast.If, ast.IfExp))
              and _mentions_sentinel(node.test)]
    refs = _ref_names(ctx.tree)
    for g in guards:
        if _calls_ref(g, refs):
            yield ctx.finding(
                "overflow-guard", g,
                "overflow guard falls back to the plain version: a CUDA "
                "tensor past the int32 range must raise, not take the "
                "plain path", _HINT)
    if not any(isinstance(n, ast.Raise)
               for g in guards if isinstance(g, ast.If)
               for b in _branches(g) for n in ast.walk(b)):
        first = guards[0] if guards else next(
            (n for n in ast.walk(ctx.tree)
             if isinstance(n, ast.FunctionDef)), None)
        yield ctx.finding(
            "overflow-guard", first or 1,
            "no int32 overflow guard that raises: the kernel launches "
            "without bounding its c_int arguments", _HINT)

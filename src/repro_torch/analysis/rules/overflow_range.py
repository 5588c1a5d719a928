"""overflow-range: *prove* each ctypes launch's int32 arguments in range.

The file-scope ``overflow-guard`` rule checks a raising guard exists; this
program-scope rule checks the guards are *sufficient*.  Every top-level
function of a kernel ``ops.py`` is run through the interval engine
(:class:`repro_torch.analysis.flow.intervals.FlowInterp`).  A **launch**
is a call of an attribute of a ``load_kernel(...)`` result — a ctypes
entry of the kernel's library — made directly (``fn(...)``,
``lib.entry(...)``) or through a same-module helper that forwards its
``*args`` to the entry (``_launch(fn, name, t, *args)`` calling
``fn(*args, stream)``).  The rule reads the entry's ``argtypes``
assignment in the same function (``fn.argtypes = [ctypes.c_void_p] * 5 +
[ctypes.c_int] * 7 + ...``) and maps the call's arguments onto it: those
before a starred argument from the front, those after it from the back.
Then, on every path that reaches the launch:

* every value passed at a ``ctypes.c_int`` position must be proven within
  ``[-2**31, 2**31 - 1]`` — by interval, by a dominating guard on the same
  canonical expression (``if max(B, S, H) > _I32_MAX: raise``), or by
  factor cover, as in the reference.  ctypes wraps a Python int that does
  not fit a C int without a word, so an unproven value is a silent wrong
  extent;
* every operand that the entry indexes with 32-bit arithmetic, passed as
  ``X.data_ptr()``, must have ``X``'s element count proven ``<= 2**31 -
  1`` the same way.  Which operands those are is read from each entry's
  CUDA source and carried in :data:`INT32_INDEXED`, one row an entry with
  its ``.cu`` file and line; an entry without a row is itself reported, so
  a new entry is audited before it launches.

A launch whose argument count disagrees with its ``argtypes``, or whose
entry has no ``argtypes`` declared before it, is reported too.  Anything
unproven is reported with its symbolic expression.  :func:`resolve_launches`
returns the launch sites the rule resolved (file, line, kernel, entries,
argtypes), which ``chip_smoke.py`` holds against the built libraries.
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from .. import FileContext, ProgramContext, iter_python_files, register_rule
from ..flow.intervals import (AVal, EntryRef, FlowInterp, I32_MAX, I32_MIN,
                              SVal, count_expr_str, prove_count, prove_int,
                              s_atom, sym_str)
from ._util import dotted

__all__ = ["INT32_INDEXED", "LaunchSite", "c_signature",
           "resolve_launches"]

_OPS_RE = re.compile(r"repro_torch/kernels/[^/]+/ops\.py$")
_INT_TYPES = ("c_int", "c_int32")   # ctypes' c_int32 is c_int

#: (kernel, entry) -> (argument positions whose operand the entry indexes
#: with 32-bit arithmetic, where that is read in the CUDA source).  An
#: empty tuple: every operand is indexed with 64-bit offsets.
INT32_INDEXED: dict[tuple[str, str], tuple[tuple[int, ...], str]] = {
    ("bna_step", "bna_step_launch"): (
        (3,), "bna_step/csrc/bna_step.cu:222; D[b] with int b at :80-82, "
              "the rest at int64 base (:81, :148)"),
    ("bna_step", "bna_step_launch_i64"): (
        (3,), "bna_step/csrc/bna_step.cu:228; as bna_step_launch"),
    ("bna_step", "bna_step_empty_launch"): (
        (), "bna_step/csrc/bna_step.cu:217; no operand"),
    ("bna_decompose", "bna_decompose_layout"): (
        (), "bna_decompose/csrc/bna_decompose.cu:650; no operand"),
    ("bna_decompose", "bna_decompose_launch"): (
        (1, 6, 7), "bna_decompose/csrc/bna_decompose.cu:664; ks[b], "
                   "D_final[b], nsteps[b] with int b at :513-515, "
                   ":592-593; the matrices at int64 offsets (:523-572)"),
    ("coflow_merge", "coflow_merge_launch"): (
        (), "coflow_merge/csrc/coflow_merge.cu:150; alphas[k] with int64 k "
            "(:39-41), the carry at int64 offsets (merge_scan.cuh:78-116)"),
    ("merge_fix", "merge_fix_launch"): (
        (), "merge_fix/csrc/merge_fix.cu:378; edges and rows at int64 "
            "offsets (:152-215), chunk-local bin offsets"),
    ("flash_attention", "flash_attention_launch"): (
        (), "flash_attention/csrc/flash_attention.cu:1821; long long "
            "strides, lse at long long offsets (:357, :1455)"),
    ("flash_attention", "attn_bwd_prep_launch"): (
        (), "flash_attention/csrc/flash_attention.cu:1892; long long rows "
            "(:1898, D[row] at :686)"),
    ("flash_attention", "attn_bwd_dkdv_launch"): (
        (), "flash_attention/csrc/flash_attention.cu:2016; long long "
            "strides and row bases (:1665)"),
    ("flash_attention", "attn_bwd_dq_launch"): (
        (), "flash_attention/csrc/flash_attention.cu:1964; long long "
            "strides and row bases (:1115, :1538)"),
    ("ssd_scan", "ssd_scan_launch"): (
        (), "ssd_scan/csrc/ssd_scan.cu:907; long long strides and chunk "
            "offsets (:117, :375, :440, :532)"),
    ("ssd_scan", "ssd_bwd_state_launch"): (
        (), "ssd_scan/csrc/ssd_scan_bwd.cu:680; long long offsets "
            "(:315-325)"),
    ("ssd_scan", "ssd_bwd_parts"): (
        (), "ssd_scan/csrc/ssd_scan_bwd.cu:702; no operand"),
    ("ssd_scan", "ssd_bwd_chunk_launch"): (
        (), "ssd_scan/csrc/ssd_scan_bwd.cu:713; long long strides and "
            "offsets (:388-397; ssd_scan_bwd_mma.cu:818-820)"),
}

_HINT = ("guard every extent passed at a ctypes.c_int argument before the "
         "launch (`if max(B, S, H) > _I32_MAX: raise`), bound parameters "
         "from both sides (`if not 0 <= n <= _I32_MAX: raise`), and "
         "validate operand shapes (`if x.shape != (B, w): raise`) so one "
         "guard covers the operands whose element count the kernel "
         "indexes in 32 bits")


@dataclass(frozen=True)
class LaunchSite:
    """One resolved launch: where, which library entries, their argtypes
    (ctypes type names, None where unreadable)."""

    path: str
    line: int
    function: str
    kernel: Optional[str]
    entries: tuple[str, ...]
    argtypes: Optional[tuple[str, ...]]


def _parse_types(expr: ast.AST, mi, index) -> Optional[list[str]]:
    """``[ctypes.c_void_p] * 5 + [ctypes.c_int] * 7`` -> type names."""
    if isinstance(expr, (ast.List, ast.Tuple)):
        out = []
        for el in expr.elts:
            parts = dotted(el)
            if parts is None:
                return None
            full = index.resolve(mi, ".".join(parts)) or ".".join(parts)
            out.append(full.rsplit(".", 1)[-1])
        return out
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        a = _parse_types(expr.left, mi, index)
        b = _parse_types(expr.right, mi, index)
        return a + b if a is not None and b is not None else None
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Mult):
        lst, n = expr.left, expr.right
        if isinstance(lst, ast.Constant):
            lst, n = n, lst
        if isinstance(n, ast.Constant) and isinstance(n.value, int):
            a = _parse_types(lst, mi, index)
            return a * n.value if a is not None else None
    return None


def _argtypes_assignments(fn: ast.AST) -> dict[str, list[tuple[int, ast.AST]]]:
    """``<expr>.argtypes = value`` in `fn`: unparsed <expr> -> [(line,
    value), ...] in source order."""
    out: dict[str, list[tuple[int, ast.AST]]] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Attribute) and t.attr == "argtypes":
                    out.setdefault(ast.unparse(t.value), []).append(
                        (node.lineno, node.value))
    for v in out.values():
        v.sort(key=lambda x: x[0])
    return out


def _forwarding(fn: ast.FunctionDef) -> Optional[tuple[int, int, int]]:
    """(entry parameter index, fixed positional parameters, arguments the
    helper adds after ``*args``) when `fn` calls one of its parameters
    with its ``*args`` first; None otherwise."""
    a = fn.args
    if a.vararg is None:
        return None
    params = [p.arg for p in a.posonlyargs + a.args]
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in params and node.args and \
                isinstance(node.args[0], ast.Starred) and \
                isinstance(node.args[0].value, ast.Name) and \
                node.args[0].value.id == a.vararg.arg and \
                not any(isinstance(x, ast.Starred) for x in node.args[1:]):
            return params.index(node.func.id), len(params), \
                len(node.args) - 1
    return None


def _positions(call_args: list, n_types: int, n_trailing: int):
    """[(argtypes position, ast arg, value)] for the arguments that can be
    placed: before the first starred one from the front, after the last
    from the back; None when the count cannot agree."""
    starred = [i for i, (a, _) in enumerate(call_args)
               if isinstance(a, ast.Starred)]
    if not starred:
        if len(call_args) + n_trailing != n_types:
            return None
        return [(i, a, v) for i, (a, v) in enumerate(call_args)]
    head = call_args[:starred[0]]
    tail = call_args[starred[-1] + 1:]
    if len(head) + len(tail) + n_trailing > n_types:
        return None
    at = n_types - n_trailing - len(tail)
    return [(i, a, v) for i, (a, v) in enumerate(head)] + \
        [(at + j, a, v) for j, (a, v) in enumerate(tail)]


class _Scan:
    """One pass over the kernel ops.py files: launch sites and findings."""

    def __init__(self, program: ProgramContext):
        self.program = program
        self.index = program.index
        self.sites: dict[tuple, LaunchSite] = {}
        self.findings: list = []

    def run(self) -> "_Scan":
        for fc in self.program.files:
            if not _OPS_RE.search(fc.rel):
                continue
            mi = self.index.by_rel.get(fc.rel)
            if mi is None:
                continue
            found: dict[tuple, tuple] = {}
            for stmt in mi.ctx.tree.body:
                if isinstance(stmt, ast.FunctionDef):
                    self._function(fc, mi, stmt, found)
            for _key, (node, msg) in sorted(found.items(),
                                            key=lambda kv: kv[0]):
                self.findings.append(
                    fc.finding("overflow-range", node, msg, _HINT))
        return self

    def _function(self, fc, mi, fn: ast.FunctionDef, found: dict) -> None:
        assigns = _argtypes_assignments(fn)
        holder: dict = {}

        def on_call(node, env, args, kwargs):
            self._on_call(fc, mi, fn, assigns, holder["interp"], node, env,
                          args, found)

        interp = FlowInterp(self.index, mi, on_call=on_call)
        holder["interp"] = interp
        try:
            interp.run_function(fn)
        except Exception:
            pass

    def _entry_call(self, mi, interp, node, env, args):
        """(EntryRef, entry expression, [(ast arg, value)], trailing) of a
        launch, or None when `node` launches nothing."""
        callee = interp.eval(node.func, env, hook=False)
        pairs = list(zip(node.args, args))
        if isinstance(callee, EntryRef):
            return callee, node.func, pairs, 0
        hit = next((i for i, v in enumerate(args)
                    if isinstance(v, EntryRef)), None)
        if hit is None:
            return None
        parts = dotted(node.func)
        fqn = self.index.resolve(mi, ".".join(parts)) if parts else None
        _owner, fdef = self.index.lookup_function(fqn)
        fwd = _forwarding(fdef) if fdef is not None else None
        if fwd is None or fwd[0] != hit:
            return args[hit], node.args[hit], None, 0
        return args[hit], node.args[hit], pairs[fwd[1]:], fwd[2]

    def _on_call(self, fc, mi, fn, assigns, interp, node, env, args,
                 found) -> None:
        got = self._entry_call(mi, interp, node, env, args)
        if got is None:
            return
        entry, expr, call_args, n_trailing = got
        names = sorted(e for _k, e in entry.entries)
        kernel = sorted({k for k, _e in entry.entries if k})
        label = "/".join(names)
        if call_args is None:
            found.setdefault((node.lineno, -1, "fwd"), (
                node, f"{label} is passed to a call that does not forward "
                      "its *args to it: its arguments cannot be checked"))
            return
        key = ast.unparse(expr)
        decl = [v for line, v in assigns.get(key, []) if line < node.lineno]
        types = _parse_types(decl[-1], mi, self.index) if decl else None
        site_key = (fc.rel, node.lineno, tuple(names))
        if site_key not in self.sites:
            self.sites[site_key] = LaunchSite(
                fc.rel, node.lineno, fn.name,
                kernel[0] if len(kernel) == 1 else None, tuple(names),
                tuple(types) if types is not None else None)
        if types is None:
            found.setdefault((node.lineno, -1, "decl"), (
                node, f"{label}() is launched with no readable argtypes "
                      f"declaration on {key!r} before it: ctypes passes "
                      "its ints unchecked"))
            return
        placed = _positions(call_args, len(types), n_trailing)
        if placed is None:
            found.setdefault((node.lineno, -1, "count"), (
                node, f"{label}() gets {len(call_args) + n_trailing} "
                      f"arguments, its argtypes declare {len(types)}"))
            return
        by_pos = {pos: (a, v) for pos, a, v in placed}
        n_known = len(call_args) + n_trailing
        for pos, typ in enumerate(types):
            if typ not in _INT_TYPES:
                continue
            a, v = by_pos.get(pos, (None, None))
            if v is not None and prove_int(v, env, I32_MIN, I32_MAX):
                continue
            what = sym_str(v) if v is not None else (
                "a value the helper adds" if pos >= n_known - n_trailing
                else "a value inside a starred argument")
            found.setdefault((node.lineno, pos, "int"), (
                node, f"cannot prove argument {pos} of {label}() "
                      f"(ctypes.{typ}) fits a C int: {what} is unbounded "
                      "on some path"))
        for k, e in sorted(entry.entries, key=lambda x: (str(x[0]), x[1])):
            row = INT32_INDEXED.get((k, e))
            if row is None:
                found.setdefault((node.lineno, -1, f"row:{e}"), (
                    node, f"entry {e} of {k} has no row in overflow_range."
                          "INT32_INDEXED: read its CUDA source for the "
                          "operands it indexes in 32 bits and add one"))
                continue
            for pos in row[0]:
                a, _v = by_pos.get(pos, (None, None))
                ok, what = self._operand(interp, a, env)
                if not ok:
                    found.setdefault((node.lineno, pos, "numel"), (
                        node, f"cannot prove operand {pos} of {e}() has at "
                              f"most 2**31 - 1 elements ({row[1]}): "
                              f"element count {what} is unbounded on some "
                              "path"))

    @staticmethod
    def _operand(interp, a, env) -> tuple[bool, str]:
        if not (isinstance(a, ast.Call) and isinstance(a.func, ast.Attribute)
                and a.func.attr == "data_ptr" and not a.args):
            return False, "of an argument that is not X.data_ptr()"
        val = interp.eval(a.func.value, env, hook=False)
        if isinstance(val, AVal) and val.dims:
            if prove_count(val, env, I32_MAX):
                return True, ""
            return False, count_expr_str(val, env)
        if isinstance(val, (AVal, SVal)) and val.sym is not None:
            if env.sym_iv(s_atom(("size", val.sym))).hi <= I32_MAX:
                return True, ""
        return False, f"{ast.unparse(a.func.value)}.numel()"


def c_signature(source: str, entry: str) -> Optional[list[str]]:
    """The ctypes type of each parameter of ``extern "C" ... entry(...)``
    in a CUDA source: pointers ``c_void_p``, ``int`` ``c_int``, ``long
    long`` ``c_longlong``, ``float`` ``c_float``; None when the entry is
    not declared there."""
    m = re.search(r'extern\s+"C"[^;{]*?\b' + re.escape(entry)
                  + r"\s*\(([^)]*)\)", source)
    if m is None:
        return None
    out = []
    for param in m.group(1).split(","):
        decl = " ".join(param.replace("*", " * ").split()[:-1])
        if "*" in decl:
            out.append("c_void_p")
        else:
            words = decl.replace("const ", "").split()
            out.append({"int": "c_int", "long long": "c_longlong",
                        "float": "c_float"}.get(" ".join(words), "?"))
    return out


def resolve_launches(paths, root) -> list[LaunchSite]:
    """Every ctypes launch site of the kernel ops.py files under `paths`
    (paths relative to `root` classify them, as in ``scan_paths``)."""
    root = Path(root).resolve()
    files = []
    for path in iter_python_files(paths):
        text = path.read_text(encoding="utf-8")
        files.append(FileContext(path, path.relative_to(root).as_posix(),
                                 text, ast.parse(text), text.splitlines()))
    return sorted(_Scan(ProgramContext(files)).run().sites.values(),
                  key=lambda s: (s.path, s.line))


@register_rule("overflow-range",
               "interval engine must prove every ctypes.c_int argument and "
               "every 32-bit-indexed operand's element count of each kernel "
               "launch fits int32 on every path",
               scope="program")
def _overflow_range(ctx: ProgramContext):
    yield from _Scan(ctx).run().findings

"""Integer-interval abstract interpretation with symbolic shapes.

This is the engine behind the ``overflow-range`` rule: a path-sensitive
abstract interpreter over one function at a time that tracks, for every
local name, an :class:`IV` integer interval *and* a canonical symbolic
expression, and for every locally-constructed / padded array a tuple of
symbolic dimensions.  Guards (``if expr > _I32_MAX: raise``) refine the
fall-through state — including **product bounds**: a bound on
``b_pad * w_pad * w_pad`` proves any operand whose element count is a
sub-product of those factors (remaining factors provably >= 1), and a
bound on ``max(B, S, H)`` bounds each argument.  The point is to prove,
at each ctypes *launch site* of a kernel library, that every value passed
at a ``c_int`` position fits a C int and that every operand the kernel
indexes in 32 bits has at most ``2**31 - 1`` elements — or to report the
unproven expression.

Scope and honesty: the abstract domain covers the wrapper idioms the
port's kernels use — ``x.shape`` unpacking, ``x.shape[i]``, ``x.size(i)``,
``x.numel()``, raising shape-equality validation (``x.shape != (B, w)``,
``tuple(x.shape) != ...``), ``torch.empty/zeros/ones/full`` and their
``*_like`` forms, shape-preserving ``.contiguous()/.to()/.float()``
chains, ``.view/.reshape/.expand``, ``int(...)``, the numpy
constructors, and straight-line helper summaries — with
commutative-sum/product canonicalization so ``Sp`` matches ``S + pad``.
A kernel library is a value too: ``load_kernel("k")`` is a
:class:`LibRef`, its attributes :class:`EntryRef` ctypes entries, which
the rule recognises at a call.  Anything outside the domain evaluates to
an *unknown*, and unknowns make launches unprovable, never silently
proven: the analysis fails toward reporting.
"""
from __future__ import annotations

import ast
from typing import Callable, NamedTuple, Optional

from .modules import ModuleInfo, ProjectIndex

__all__ = ["IV", "SVal", "AVal", "Env", "FlowInterp", "I32_MAX", "I32_MIN",
           "LibRef", "EntryRef", "prove_count", "prove_int",
           "count_expr_str", "sym_str"]

I32_MAX = 2**31 - 1
I32_MIN = -2**31
INF = float("inf")


# ---------------------------------------------------------------------------
# interval lattice
# ---------------------------------------------------------------------------

class IV(NamedTuple):
    """Closed integer interval; +-inf endpoints for unbounded sides."""

    lo: float
    hi: float

    def is_const(self) -> bool:
        return self.lo == self.hi and self.lo not in (INF, -INF)

    def join(self, o: "IV") -> "IV":
        return IV(min(self.lo, o.lo), max(self.hi, o.hi))

    def meet(self, o: "IV") -> "IV":
        lo, hi = max(self.lo, o.lo), min(self.hi, o.hi)
        return IV(lo, hi) if lo <= hi else IV(lo, lo)  # empty -> point

    def add(self, o: "IV") -> "IV":
        return IV(self.lo + o.lo, self.hi + o.hi)

    def sub(self, o: "IV") -> "IV":
        return IV(self.lo - o.hi, self.hi - o.lo)

    def neg(self) -> "IV":
        return IV(-self.hi, -self.lo)

    def mul(self, o: "IV") -> "IV":
        cands = [_m(a, b) for a in (self.lo, self.hi)
                 for b in (o.lo, o.hi)]
        return IV(min(cands), max(cands))

    def floordiv(self, o: "IV") -> "IV":
        if o.lo <= 0:
            return TOP
        cands = []
        for a in (self.lo, self.hi):
            for b in (o.lo, o.hi):
                if b in (0, INF, -INF):
                    cands.append(0.0 if a not in (INF, -INF) else a)
                elif a in (INF, -INF):
                    cands.append(a)
                else:
                    cands.append(a // b)
        return IV(min(cands), max(cands))

    def mod(self, o: "IV") -> "IV":
        if o.lo > 0 and o.hi != INF:
            return IV(0, o.hi - 1)
        if o.lo > 0:
            return IV(0, INF)
        return TOP

    def lshift(self, o: "IV") -> "IV":
        if self.lo < 0 or o.lo < 0:
            return TOP
        lo = self.lo * (2 ** min(o.lo, 63)) if self.lo not in (INF,) else INF
        hi = INF if (self.hi == INF or o.hi == INF or o.hi > 63) \
            else self.hi * (2 ** o.hi)
        return IV(lo, hi)


def _m(a: float, b: float) -> float:
    if a in (INF, -INF) or b in (INF, -INF):
        if a == 0 or b == 0:
            return 0.0
    return a * b


TOP = IV(-INF, INF)
NONNEG = IV(0, INF)


def const_iv(v: float) -> IV:
    return IV(v, v)


# ---------------------------------------------------------------------------
# canonical symbolic expressions (hashable nested tuples)
# ---------------------------------------------------------------------------
#   ("c", int)                       constant
#   ("a", key)                       opaque atom (param, shape dim, ...)
#   ("+", const, ((term, coeff), ...))  linear combination, terms sorted
#   ("*", coeff, (f1, f2, ...))      product, factors sorted, reps allowed
#   ("//" | "%" | "<<", a, b)        non-linear binary ops
#   ("min" | "max", (args...))       sorted args
#   ("call", name, (args...))        pure call / opaque method
#   ("?", a, b)                      joined alternatives (if-exp)

def s_const(v: int):
    return ("c", int(v))


def s_atom(key) -> tuple:
    return ("a", key)


def _as_sum(e) -> tuple[int, dict]:
    if e[0] == "c":
        return e[1], {}
    if e[0] == "+":
        return e[1], dict(e[2])
    return 0, {e: 1}


def s_sum(const: int, terms: dict) -> tuple:
    terms = {t: c for t, c in terms.items() if c != 0}
    if not terms:
        return s_const(const)
    if const == 0 and len(terms) == 1:
        (t, c), = terms.items()
        if c == 1:
            return t
        if t[0] == "*":
            return s_mul_make(c * t[1], list(t[2]))
    return ("+", const, tuple(sorted(terms.items(), key=repr)))


def s_add(a, b) -> tuple:
    ca, ta = _as_sum(a)
    cb, tb = _as_sum(b)
    for t, c in tb.items():
        ta[t] = ta.get(t, 0) + c
    return s_sum(ca + cb, ta)


def s_neg(a) -> tuple:
    c, t = _as_sum(a)
    return s_sum(-c, {k: -v for k, v in t.items()})


def s_sub(a, b) -> tuple:
    return s_add(a, s_neg(b))


def s_mul_make(coeff: int, factors: list) -> tuple:
    if coeff == 0:
        return s_const(0)
    flat: list = []
    for f in factors:
        if f[0] == "c":
            coeff *= f[1]
        elif f[0] == "*":
            coeff *= f[1]
            flat.extend(f[2])
        else:
            flat.append(f)
    if coeff == 0:
        return s_const(0)
    if not flat:
        return s_const(coeff)
    if len(flat) == 1:
        # c*x is canonically the one-term sum ("+", 0, ((x, c),)) — the
        # same form s_add produces — so x + x and 2*x meet and cancel
        return flat[0] if coeff == 1 else ("+", 0, ((flat[0], coeff),))
    return ("*", coeff, tuple(sorted(flat, key=repr)))


def s_mul(a, b) -> tuple:
    # fold constant * sum into the sum (keeps 2*m canonical either way)
    if a[0] == "c" and b[0] == "+":
        a, b = b, a
    if b[0] == "c" and a[0] == "+":
        k = b[1]
        return s_sum(a[1] * k, {t: c * k for t, c in a[2]})
    return s_mul_make(1, [a, b])


def s_factors(e) -> tuple[int, tuple]:
    """(coeff, factor multiset) of a canonical product-like expression."""
    if e[0] == "*":
        return e[1], e[2]
    if e[0] == "c":
        return e[1], ()
    return 1, (e,)


_FRESH = [0]


def fresh_atom(tag: str) -> tuple:
    _FRESH[0] += 1
    return s_atom(f"{tag}#{_FRESH[0]}")


# ---------------------------------------------------------------------------
# abstract values
# ---------------------------------------------------------------------------

class SVal(NamedTuple):
    """Scalar: interval + canonical symbolic expression (None = opaque)."""

    iv: IV
    sym: Optional[tuple]


class AVal(NamedTuple):
    """Array: per-dimension scalar abstractions + an identity symbol.
    ``exact`` is False when only the leading dims are known (``x.shape[0]``
    read alone): then the dims are not the whole shape, and no element
    count is derived from them."""

    dims: tuple          # tuple[SVal, ...]
    sym: tuple           # identity atom (for .size / method canon)
    exact: bool = True


class ShapeRef(NamedTuple):
    """Transient value of an ``x.shape`` expression."""

    base: object         # the array's env slot name or AVal
    name: Optional[str]  # env name holding the array, when known


class AtRef(NamedTuple):
    """Transient value of ``x.at`` — indexing it keeps x's shape."""

    aval: "AVal"


class LibRef(NamedTuple):
    """A kernel library: the value of ``load_kernel("<kernel>")``."""

    kernel: Optional[str]


class EntryRef(NamedTuple):
    """A ctypes entry of a kernel library (``lib.<entry>``); a conditional
    between entries (``lib.a if c else lib.b``) holds both."""

    entries: frozenset   # {(kernel, entry), ...}


def unknown_sval(tag: str = "v") -> SVal:
    return SVal(TOP, fresh_atom(tag))


def unknown_aval(tag: str = "arr") -> AVal:
    return AVal((), fresh_atom(tag))   # () dims = rank unknown


class Env:
    """One path's abstract state."""

    def __init__(self):
        self.vars: dict[str, object] = {}
        self.refine: dict[tuple, IV] = {}     # canonical sym -> interval
        self.prods: list[tuple[tuple, float]] = []  # (factor multiset, hi)
        self.funcs: dict[str, tuple] = {}     # local def name -> (node,)

    def copy(self) -> "Env":
        e = Env()
        e.vars = dict(self.vars)
        e.refine = dict(self.refine)
        e.prods = list(self.prods)
        e.funcs = dict(self.funcs)
        return e

    def meet_sym(self, sym: tuple, iv: IV) -> None:
        cur = self.refine.get(sym, TOP)
        self.refine[sym] = cur.meet(iv)

    def iv_of(self, val: object) -> IV:
        if isinstance(val, SVal):
            iv = val.iv
            if val.sym is not None:
                iv = iv.meet(self.sym_iv(val.sym))
            return iv
        return TOP

    def sym_iv(self, sym: tuple) -> IV:
        """Best interval for a canonical expression: refinement table plus
        a structural recomputation over refined parts."""
        iv = self.refine.get(sym, TOP)
        g = self.ground(sym)
        if g != sym:
            iv = iv.meet(self.refine.get(g, TOP))
        iv = iv.meet(self._structural_iv(sym))
        return iv

    def _structural_iv(self, sym: tuple, depth: int = 0) -> IV:
        if depth > 8:
            return TOP
        tag = sym[0]
        if tag == "c":
            return const_iv(sym[1])
        if tag == "a":
            return self.refine.get(sym, TOP)
        sub = self.refine.get(sym)
        if sub is not None:
            return sub
        if tag == "+":
            iv = const_iv(sym[1])
            for t, c in sym[2]:
                ti = self._structural_iv(t, depth + 1).meet(
                    self.refine.get(t, TOP))
                iv = iv.add(ti.mul(const_iv(c)))
            return iv
        if tag == "*":
            iv = const_iv(sym[1])
            for f in sym[2]:
                fi = self._structural_iv(f, depth + 1).meet(
                    self.refine.get(f, TOP))
                iv = iv.mul(fi)
            return iv
        if tag in ("min", "max"):
            ivs = [self._structural_iv(a, depth + 1).meet(
                self.refine.get(a, TOP)) for a in sym[1]]
            if tag == "min":
                return IV(min(i.lo for i in ivs), min(i.hi for i in ivs))
            return IV(max(i.lo for i in ivs), max(i.hi for i in ivs))
        if tag == "?":
            return self._structural_iv(sym[1], depth + 1).join(
                self._structural_iv(sym[2], depth + 1))
        if tag == "<<":
            return self._structural_iv(sym[1], depth + 1).lshift(
                self._structural_iv(sym[2], depth + 1))
        if tag == "//":
            return self._structural_iv(sym[1], depth + 1).floordiv(
                self._structural_iv(sym[2], depth + 1))
        if tag == "%":
            return self._structural_iv(sym[1], depth + 1).mod(
                self._structural_iv(sym[2], depth + 1))
        return TOP

    def ground(self, sym: tuple, depth: int = 0) -> tuple:
        """Substitute singleton-interval subexpressions with their constant
        and re-canonicalize (so ``S + pad`` under ``pad == 0`` matches
        ``S``, including when ``pad`` is itself a ``%`` expression)."""
        if depth > 8 or not isinstance(sym, tuple):
            return sym
        tag = sym[0]
        if tag == "c":
            return sym
        known = self.refine.get(sym)
        if known is not None and known.is_const():
            return s_const(int(known.lo))
        if tag == "a":
            return sym
        if tag == "+":
            out = s_const(sym[1])
            for t, c in sym[2]:
                out = s_add(out, s_mul(self.ground(t, depth + 1), s_const(c)))
            return out
        if tag == "*":
            out = s_const(sym[1])
            for f in sym[2]:
                out = s_mul(out, self.ground(f, depth + 1))
            return out
        if tag in ("min", "max"):
            return (tag, tuple(sorted((self.ground(a, depth + 1)
                                       for a in sym[1]), key=repr)))
        if tag in ("//", "%", "<<", "?"):
            return (tag, self.ground(sym[1], depth + 1),
                    self.ground(sym[2], depth + 1))
        if tag == "call":
            return (tag, sym[1], tuple(self.ground(a, depth + 1)
                                       for a in sym[2]))
        return sym


# ---------------------------------------------------------------------------
# launch-proof helpers
# ---------------------------------------------------------------------------

def _covers(bound_fs: tuple, fs: tuple, env: Env) -> bool:
    """Does the recorded bound's factor multiset cover `fs`, with every
    uncovered extra factor provably >= 1 (a sub-product of a bounded
    product of >=1 factors is bounded)?"""
    remaining = list(bound_fs)
    for f in fs:
        if f in remaining:
            remaining.remove(f)
        else:
            return False
    return all(env.sym_iv(f).lo >= 1 for f in remaining)


def prove_count(aval: AVal, env: Env, bound: int = I32_MAX) -> bool:
    """Is this array's element count provably <= `bound` in `env`?"""
    if not isinstance(aval, AVal) or not aval.dims or not aval.exact:
        return False
    iv = const_iv(1)
    syms = []
    for d in aval.dims:
        div = env.iv_of(d) if isinstance(d, SVal) else TOP
        iv = iv.mul(div.meet(NONNEG))
        syms.append(d.sym if isinstance(d, SVal) else None)
    if iv.hi <= bound:
        return True
    if any(s is None for s in syms):
        return False
    count = s_const(1)
    for s in syms:
        count = s_mul(count, s)
    if env.sym_iv(count).hi <= bound:
        return True
    coeff, fs = s_factors(env.ground(count))
    if coeff < 1:
        return False
    for bfs, bhi in env.prods:
        if bhi * 1 <= bound * 1 and _covers(
                tuple(env.ground(f) for f in bfs), fs, env) \
                and bhi * coeff <= bound:
            return True
    return False


def count_expr_str(aval: AVal, env: Env) -> str:
    """Human-readable element-count expression for a finding message."""
    if not isinstance(aval, AVal) or not aval.dims or not aval.exact:
        return "<unknown shape>"
    return " * ".join(_render(d.sym) if isinstance(d, SVal) and d.sym
                      else "?" for d in aval.dims)


def prove_int(val, env: Env, lo: int = I32_MIN, hi: int = I32_MAX) -> bool:
    """Is this scalar provably in ``[lo, hi]`` (a C int's range) in `env`?"""
    if not isinstance(val, SVal):
        return False
    iv = env.iv_of(val)
    return iv.lo >= lo and iv.hi <= hi


def sym_str(val) -> str:
    """Human-readable expression of a scalar, for a finding message."""
    if isinstance(val, SVal) and val.sym is not None:
        return _render(val.sym)
    return "?"


def _render(sym, depth: int = 0) -> str:
    if depth > 6 or not isinstance(sym, tuple):
        return "?"
    tag = sym[0]
    if tag == "c":
        return str(sym[1])
    if tag == "a":
        key = sym[1]
        if isinstance(key, tuple):
            if key and key[0] == "shape" and len(key) == 3:
                return f"{_render(key[1], depth + 1)}.shape[{key[2]}]"
            if key and key[0] == "attr" and len(key) == 3:
                return f"{_render(key[1], depth + 1)}.{key[2]}"
            if key and key[0] == "size" and len(key) == 2:
                return f"{_render(key[1], depth + 1)}.numel()"
            return "?"
        return str(key).split(":")[-1].split("#")[0] or str(key)
    if tag == "+":
        parts = [str(sym[1])] if sym[1] else []
        for t, c in sym[2]:
            parts.append(_render(t, depth + 1) if c == 1
                         else f"{c}*{_render(t, depth + 1)}")
        return "(" + " + ".join(parts) + ")"
    if tag == "*":
        parts = [str(sym[1])] if sym[1] != 1 else []
        parts += [_render(f, depth + 1) for f in sym[2]]
        return "*".join(parts)
    if tag in ("min", "max"):
        return f"{tag}({', '.join(_render(a, depth + 1) for a in sym[1])})"
    if tag in ("//", "%", "<<"):
        return f"({_render(sym[1], depth + 1)} {tag} " \
               f"{_render(sym[2], depth + 1)})"
    if tag == "call":
        return f"{sym[1]}(...)"
    return "?"


# ---------------------------------------------------------------------------
# the path-sensitive interpreter
# ---------------------------------------------------------------------------

_NP_HEADS = ("numpy", "jax.numpy", "torch")
_CTORS = {"zeros", "ones", "full", "empty"}
_LIKE_CTORS = {"empty_like", "zeros_like", "ones_like", "full_like",
               "rand_like", "randn_like"}
_NEW_CTORS = {"new_empty", "new_zeros", "new_ones", "new_full"}
_RESHAPE_METHODS = {"view", "reshape", "expand"}
_ELEMWISE = {"log", "exp", "sqrt", "abs", "floor", "ceil", "maximum",
             "minimum", "where", "clip", "negative", "logical_not"}
_PASSTHRU = {"asarray", "ascontiguousarray", "array"}
_SHAPE_PRESERVING_METHODS = {"astype", "copy", "add", "set", "mul", "min",
                             "max", "multiply", "clip", "T",
                             # torch: copies, casts and in-place fills
                             "contiguous", "to", "float", "double", "half",
                             "bfloat16", "int", "long", "cpu", "cuda",
                             "clone", "detach", "zero_", "copy_", "fill_"}


class _Return(Exception):
    pass


class FlowInterp:
    """Abstract interpreter for one function (plus straight-line helper
    summaries).  ``on_call(node, env, args, kwargs)`` fires at every Call
    evaluation in the *root* function — the rule's launch hook."""

    def __init__(self, index: ProjectIndex, module: ModuleInfo,
                 on_call: Optional[Callable] = None,
                 max_paths: int = 160, depth: int = 0):
        self.index = index
        self.module = module
        self.on_call = on_call
        self.max_paths = max_paths
        self.depth = depth
        self._paths = 0
        self._module_env: Optional[Env] = None

    # --- module environment ----------------------------------------------

    def module_env(self) -> Env:
        """Top-level constants evaluated once (sentinels like ``_I32_MAX =
        int(np.iinfo(np.int32).max)`` become concrete intervals)."""
        if self._module_env is None:
            env = Env()
            self._module_env = env
            for name, expr in self.module.constants.items():
                try:
                    v = self.eval(expr, env, hook=False)
                except Exception:
                    v = unknown_sval(f"const:{name}")
                if isinstance(v, (SVal, AVal)):
                    env.vars[name] = v
        return self._module_env

    # --- entry points ------------------------------------------------------

    def run_function(self, fn: ast.FunctionDef,
                     env: Optional[Env] = None) -> list:
        """Walk every path of `fn`; returns the list of returned abstract
        values (for summaries).  `env` pre-binds params/free names."""
        base = self.module_env().copy()
        if env is not None:
            base.vars.update(env.vars)
            base.refine.update(env.refine)
            base.prods.extend(env.prods)
            base.funcs.update(env.funcs)
        for p in _params(fn):
            base.vars.setdefault(p, SVal(TOP, s_atom(f"param:{p}")))
        returns: list = []
        self._paths = 0
        self.exec_block(list(fn.body), base, returns)
        return returns

    def summarize(self, fn: ast.FunctionDef, owner: ModuleInfo,
                  args: list, kwargs: dict, parent_env: Env):
        """Evaluate a callee under its own module context; join returns."""
        if self.depth >= 3:
            return unknown_sval("deep")
        sub = FlowInterp(self.index, owner, on_call=None,
                         max_paths=32, depth=self.depth + 1)
        env = Env()
        # closures see the caller's locals only for same-module nested defs
        if owner is self.module:
            env.vars = dict(parent_env.vars)
            env.refine = dict(parent_env.refine)
            env.prods = list(parent_env.prods)
            env.funcs = dict(parent_env.funcs)
        names = _param_list(fn)
        for i, a in enumerate(args):
            if i < len(names):
                env.vars[names[i]] = a
        for k, v in kwargs.items():
            if k in names:
                env.vars[k] = v
        defaults = fn.args.defaults
        dnames = names[len(names) - len(defaults):] if defaults else []
        for n, d in zip(dnames, defaults):
            if n not in env.vars:
                try:
                    env.vars[n] = sub.eval(d, env, hook=False)
                except Exception:
                    pass
        try:
            rets = sub.run_function(fn, env)
        except Exception:
            return unknown_sval("summary")
        return _join_values(rets)

    # --- statements ---------------------------------------------------------

    def exec_block(self, stmts: list, env: Env, returns: list) -> list[Env]:
        """Execute a statement list; returns fall-through path envs."""
        envs = [env]
        for i, stmt in enumerate(stmts):
            nxt: list[Env] = []
            for e in envs:
                nxt.extend(self.exec_stmt(stmt, e, returns))
            if len(nxt) > self.max_paths:
                nxt = [_join_envs(nxt)]
            envs = nxt
            if not envs:
                break
        return envs

    def exec_stmt(self, stmt: ast.stmt, env: Env,
                  returns: list) -> list[Env]:
        try:
            return self._exec_stmt(stmt, env, returns)
        except _Return:
            raise
        except Exception:
            return [env]

    def _exec_stmt(self, stmt, env: Env, returns: list) -> list[Env]:
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            self._assign(stmt, env)
            return [env]
        if isinstance(stmt, ast.Expr):
            self.eval(stmt.value, env)
            return [env]
        if isinstance(stmt, ast.Return):
            if stmt.value is not None:
                v = self.eval(stmt.value, env)
                if isinstance(v, SVal):
                    # a summary keeps what the path's guards proved
                    v = SVal(env.iv_of(v), v.sym)
                returns.append(v)
            return []
        if isinstance(stmt, ast.Raise):
            if stmt.exc is not None:
                self.eval(stmt.exc, env)
            return []
        if isinstance(stmt, (ast.Break, ast.Continue)):
            return []
        if isinstance(stmt, ast.If):
            self.eval(stmt.test, env)
            out: list[Env] = []
            te = env.copy()
            self.refine_cond(stmt.test, te, True)
            out.extend(self.exec_block(list(stmt.body), te, returns))
            fe = env
            self.refine_cond(stmt.test, fe, False)
            out.extend(self.exec_block(list(stmt.orelse), fe, returns))
            return out
        if isinstance(stmt, ast.Assert):
            self.eval(stmt.test, env)
            self.refine_cond(stmt.test, env, True)
            return [env]
        if isinstance(stmt, (ast.While, ast.For)):
            self._havoc_assigned(stmt, env)
            be = env.copy()
            if isinstance(stmt, ast.While):
                self.eval(stmt.test, be)
                self.refine_cond(stmt.test, be, True)
            else:
                self.eval(stmt.iter, be)
            self.exec_block(list(stmt.body), be, returns)  # visit launches
            return self.exec_block(list(stmt.orelse), env, returns) \
                if stmt.orelse else [env]
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                self.eval(item.context_expr, env)
            return self.exec_block(list(stmt.body), env, returns)
        if isinstance(stmt, ast.Try):
            out = self.exec_block(list(stmt.body), env.copy(), returns)
            for h in stmt.handlers:
                out.extend(self.exec_block(list(h.body), env.copy(),
                                           returns))
            final: list[Env] = []
            for e in out or [env]:
                final.extend(self.exec_block(list(stmt.finalbody), e,
                                             returns))
            return final
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            env.funcs[stmt.name] = (stmt,)
            return [env]
        if isinstance(stmt, (ast.Import, ast.ImportFrom, ast.Pass,
                             ast.Global, ast.Nonlocal, ast.Delete,
                             ast.ClassDef)):
            return [env]
        # anything else: evaluate child expressions for hook coverage
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self.eval(child, env)
        return [env]

    def _assign(self, stmt, env: Env) -> None:
        if isinstance(stmt, ast.AugAssign):
            val = self.eval(ast.BinOp(left=stmt.target, op=stmt.op,
                                      right=stmt.value), env)
            if isinstance(stmt.target, ast.Name):
                env.vars[stmt.target.id] = val
            return
        value = stmt.value
        targets = stmt.targets if isinstance(stmt, ast.Assign) \
            else [stmt.target]
        if value is None:
            return
        # tuple-unpack of x.shape binds symbolic dims (and materializes x)
        for t in targets:
            if isinstance(t, (ast.Tuple, ast.List)):
                self._unpack(t, value, env)
            elif isinstance(t, ast.Name):
                env.vars[t.id] = self.eval(value, env)
            else:
                self.eval(value, env)   # subscript/attr store: shape-safe

    def _unpack(self, target, value, env: Env) -> None:
        elts = target.elts
        if isinstance(value, ast.Attribute) and value.attr == "shape":
            aval = self._materialize(value.value, env, rank=len(elts),
                                     exact=True)
            if aval is not None:
                for i, el in enumerate(elts):
                    if isinstance(el, ast.Name) and i < len(aval.dims):
                        env.vars[el.id] = aval.dims[i]
                return
        if isinstance(value, (ast.Tuple, ast.List)) and \
                len(value.elts) == len(elts):
            for el, vexpr in zip(elts, value.elts):
                if isinstance(el, ast.Name):
                    env.vars[el.id] = self.eval(vexpr, env)
                else:
                    self.eval(vexpr, env)
            return
        self.eval(value, env)
        for el in elts:
            if isinstance(el, ast.Name):
                env.vars[el.id] = unknown_sval(f"unpack:{el.id}")

    def _materialize(self, expr, env: Env, rank: int,
                     exact: bool = False) -> Optional[AVal]:
        """AVal for `expr` with at least `rank` dims, creating symbolic
        shape atoms on first access (stored back when expr is a Name);
        `exact` when the access shows the whole shape (a full unpack)."""
        val = self.eval(expr, env, hook=False)
        if isinstance(val, AVal) and len(val.dims) >= rank and (
                val.exact or not exact):
            return val if not exact or len(val.dims) == rank else \
                AVal(val.dims[:rank], val.sym)
        base_sym = val.sym if isinstance(val, (AVal, SVal)) and val.sym \
            else fresh_atom("arr")
        dims = tuple(SVal(NONNEG, s_atom(("shape", base_sym, i)))
                     for i in range(rank))
        for d in dims:
            env.meet_sym(d.sym, NONNEG)
        if isinstance(val, AVal) and not val.exact and val.dims:
            # keep the dims already read, extend with fresh atoms
            dims = val.dims + dims[len(val.dims):]
        aval = AVal(dims, base_sym, exact)
        if isinstance(expr, ast.Name):
            env.vars[expr.id] = aval
        return aval

    def _havoc_assigned(self, stmt, env: Env) -> None:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name) and \
                    isinstance(node.ctx, (ast.Store,)):
                env.vars[node.id] = unknown_sval(f"loop:{node.id}")
            elif isinstance(node, ast.comprehension):
                for t in ast.walk(node.target):
                    if isinstance(t, ast.Name):
                        env.vars[t.id] = unknown_sval(f"loop:{t.id}")

    # --- expressions --------------------------------------------------------

    def eval(self, node, env: Env, hook: bool = True):
        try:
            return self._eval(node, env, hook)
        except _Return:
            raise
        except Exception:
            return unknown_sval("err")

    def _eval(self, node, env: Env, hook: bool):
        if isinstance(node, ast.Constant):
            if isinstance(node.value, bool):
                return SVal(IV(int(node.value), int(node.value)),
                            s_const(int(node.value)))
            if isinstance(node.value, int):
                return SVal(const_iv(node.value), s_const(node.value))
            return SVal(TOP, fresh_atom("const"))
        if isinstance(node, ast.Name):
            if node.id in env.vars:
                return env.vars[node.id]
            sym = s_atom(f"free:{node.id}")
            return SVal(TOP, sym)
        if isinstance(node, ast.BinOp):
            return self._binop(node, env, hook)
        if isinstance(node, ast.UnaryOp):
            v = self.eval(node.operand, env, hook)
            if isinstance(node.op, ast.USub) and isinstance(v, SVal):
                return SVal(env.iv_of(v).neg(),
                            s_neg(v.sym) if v.sym else None)
            return unknown_sval("unary")
        if isinstance(node, ast.Call):
            return self._call(node, env, hook)
        if isinstance(node, ast.Attribute):
            return self._attribute(node, env, hook)
        if isinstance(node, ast.Subscript):
            return self._subscript(node, env, hook)
        if isinstance(node, ast.IfExp):
            self.eval(node.test, env, hook)
            a = self.eval(node.body, env, hook)
            b = self.eval(node.orelse, env, hook)
            if isinstance(a, EntryRef) and isinstance(b, EntryRef):
                return EntryRef(a.entries | b.entries)
            if isinstance(a, SVal) and isinstance(b, SVal):
                sym = a.sym if a.sym == b.sym else (
                    ("?", a.sym, b.sym) if a.sym and b.sym else None)
                return SVal(env.iv_of(a).join(env.iv_of(b)), sym)
            return unknown_sval("ifexp")
        if isinstance(node, ast.BoolOp):
            vals = [self.eval(v, env, hook) for v in node.values]
            svals = [v for v in vals if isinstance(v, SVal)]
            if svals:
                iv = svals[0].iv
                for v in svals[1:]:
                    iv = iv.join(env.iv_of(v))
                return SVal(iv, None)
            return unknown_sval("bool")
        if isinstance(node, ast.Compare):
            for e in [node.left, *node.comparators]:
                self.eval(e, env, hook)
            return SVal(IV(0, 1), None)
        if isinstance(node, (ast.Tuple, ast.List)):
            return tuple(self.eval(e, env, hook) for e in node.elts)
        if isinstance(node, (ast.GeneratorExp, ast.ListComp, ast.SetComp,
                             ast.DictComp)):
            return unknown_sval("comp")
        if isinstance(node, ast.Starred):
            return self.eval(node.value, env, hook)
        if isinstance(node, ast.JoinedStr):
            return unknown_sval("fstr")
        if isinstance(node, ast.Lambda):
            return unknown_sval("lambda")
        return unknown_sval("expr")

    def _binop(self, node: ast.BinOp, env: Env, hook: bool):
        a = self.eval(node.left, env, hook)
        b = self.eval(node.right, env, hook)
        if not (isinstance(a, SVal) and isinstance(b, SVal)):
            return unknown_sval("binop")
        ia, ib = env.iv_of(a), env.iv_of(b)
        sa, sb = a.sym, b.sym
        op = node.op
        if isinstance(op, ast.Add):
            return SVal(ia.add(ib),
                        s_add(sa, sb) if sa and sb else None)
        if isinstance(op, ast.Sub):
            return SVal(ia.sub(ib),
                        s_sub(sa, sb) if sa and sb else None)
        if isinstance(op, ast.Mult):
            return SVal(ia.mul(ib),
                        s_mul(sa, sb) if sa and sb else None)
        if isinstance(op, ast.FloorDiv):
            return SVal(ia.floordiv(ib),
                        ("//", sa, sb) if sa and sb else None)
        if isinstance(op, ast.Mod):
            return SVal(ia.mod(ib), ("%", sa, sb) if sa and sb else None)
        if isinstance(op, ast.LShift):
            return SVal(ia.lshift(ib),
                        ("<<", sa, sb) if sa and sb else None)
        if isinstance(op, ast.Pow):
            # constant integer powers only (2**31 - 1 sentinels)
            if ia.lo == ia.hi and ib.lo == ib.hi and ib.lo >= 0 and \
                    ia.lo == int(ia.lo) and ib.lo == int(ib.lo) and \
                    ib.lo <= 64:
                c = int(ia.lo) ** int(ib.lo)
                return SVal(IV(c, c), s_const(c))
            return unknown_sval("binop")
        if isinstance(op, ast.Div):
            return SVal(TOP, None)
        return unknown_sval("binop")

    def _resolved(self, func, env: Env) -> Optional[str]:
        from .modules import dotted
        parts = dotted(func)
        if parts is None:
            return None
        if parts[0] in env.vars or parts[0] in env.funcs:
            return None
        return self.index.resolve(self.module, ".".join(parts)) or \
            ".".join([self.module.imports.get(parts[0], parts[0])]
                     + parts[1:])

    def _call(self, node: ast.Call, env: Env, hook: bool):
        args = [self.eval(a, env, hook) for a in node.args]
        kwargs = {k.arg: self.eval(k.value, env, hook)
                  for k in node.keywords if k.arg}
        func = node.func
        if hook and self.on_call is not None:
            self.on_call(node, env, args, kwargs)
        # module-qualified / project calls dispatch on the resolved FQN
        # (tried first so np.zeros is a constructor, not a method on np)
        fqn = self._resolved(func, env)
        if fqn and fqn.rsplit(".", 1)[-1] == "load_kernel":
            first = node.args[0] if node.args else None
            return LibRef(first.value if isinstance(first, ast.Constant)
                          and isinstance(first.value, str) else None)
        if fqn:
            out = self._fqn_call(fqn, node, args, kwargs, env)
            if out is not None:
                return out
        # method calls on values -------------------------------------------
        if isinstance(func, ast.Attribute):
            base = self.eval(func.value, env, hook=False)
            name = func.attr
            if isinstance(base, AtRef):
                base = base.aval
            if isinstance(base, LibRef):
                return unknown_sval(f"entry:{name}")
            if isinstance(base, (AVal, SVal)):
                out = self._tensor_method(func, name, base, node, args, env)
                if out is not None:
                    return out
            if isinstance(base, AVal):
                if name in _SHAPE_PRESERVING_METHODS:
                    return base
                if name in ("max", "min", "sum", "prod") and node.keywords:
                    return SVal(TOP, ("call", f".{name}",
                                      (base.sym,) + _syms(args)))
                return SVal(TOP, ("call", f".{name}",
                                  (base.sym,) + _syms(args)))
            if isinstance(base, SVal):
                if name == "bit_length":
                    return SVal(IV(0, 66),
                                ("call", ".bit_length", (base.sym,))
                                if base.sym else None)
                return SVal(TOP, ("call", f".{name}",
                                  (base.sym,) + _syms(args))
                            if base.sym else None)
            return unknown_sval("method")
        # builtins and local defs ------------------------------------------
        if isinstance(func, ast.Name):
            if func.id in env.funcs:
                return self.summarize(env.funcs[func.id][0], self.module,
                                      args, kwargs, env)
            if func.id == "len":
                if args and isinstance(args[0], AVal) and args[0].dims:
                    return args[0].dims[0]
                return SVal(NONNEG, ("call", "len", _syms(args))
                            if all(s is not None for s in _syms(args))
                            else None)
            if func.id in ("min", "max") and len(args) >= 2 and \
                    all(isinstance(a, SVal) for a in args):
                ivs = [env.iv_of(a) for a in args]
                syms = _syms(args)
                if func.id == "min":
                    iv = IV(min(i.lo for i in ivs), min(i.hi for i in ivs))
                else:
                    iv = IV(max(i.lo for i in ivs), max(i.hi for i in ivs))
                sym = (func.id, tuple(sorted(syms, key=repr))) \
                    if all(s is not None for s in syms) else None
                return SVal(iv, sym)
            if func.id in ("int", "abs", "float", "round"):
                if args and isinstance(args[0], SVal):
                    if func.id == "abs":
                        iv = env.iv_of(args[0])
                        lo = 0 if iv.lo < 0 else iv.lo
                        return SVal(IV(lo, max(abs(iv.lo), abs(iv.hi))),
                                    None)
                    return args[0]
                if args and isinstance(args[0], AVal):
                    return SVal(NONNEG, None)
                return unknown_sval(func.id)
            if func.id == "bool":
                return SVal(IV(0, 1), None)
        return SVal(TOP, ("call", fqn or "?", _syms(args))
                    if all(s is not None for s in _syms(args)) else None)

    def _tensor_method(self, func: ast.Attribute, name: str, base, node,
                       args, env: Env):
        """torch's shape methods on an array (or a not yet materialized
        parameter); None = not a shape method."""
        if name == "numel" and not args:
            return _size_of(base, env)
        if name == "size" and len(args) == 1 and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, int) and \
                node.args[0].value >= 0:
            i = node.args[0].value
            aval = base if isinstance(base, AVal) and len(base.dims) > i \
                else self._materialize(func.value, env, rank=i + 1)
            return aval.dims[i] if aval is not None else None
        if name == "dim" and not args and isinstance(base, AVal) and \
                base.dims:
            return SVal(const_iv(len(base.dims)), s_const(len(base.dims)))
        if name in _RESHAPE_METHODS or name in _NEW_CTORS:
            shape = args[0] if len(args) == 1 else tuple(args)
            if name == "new_full":
                shape = args[0] if args else None
            dims = _as_dims(shape)
            if dims is None:
                return unknown_aval(f".{name}")
            if name in _RESHAPE_METHODS:
                # -1 (inferred) and expand's -1 (kept) are not tracked
                dims = [d if env.iv_of(d).lo >= 0 else unknown_sval("dim")
                        for d in dims]
            return AVal(tuple(dims), fresh_atom(f".{name}"))
        return None

    def _fqn_call(self, fqn: str, node, args, kwargs, env: Env):
        """Dispatch a call by absolute dotted name; None = not handled."""
        head, tail = fqn.rsplit(".", 1) if "." in fqn else ("", fqn)
        if head in _NP_HEADS or head.endswith(".numpy"):
            return self._np_call(tail, node, args, kwargs, env)
        if tail in ("iinfo", "finfo") and (head.startswith("numpy")
                                           or head.startswith("jax")
                                           or head.startswith("torch")):
            return ("iinfo", args[0] if args else None)
        if head.startswith("numpy") or head.startswith("jax") \
                or head.startswith("torch"):
            # np.int64(x) / np.int32(x): value-preserving casts
            if tail in ("int64", "int32", "int16", "int8") and args \
                    and isinstance(args[0], SVal):
                return args[0]
            return unknown_sval(tail)
        owner, fndef = self.index.lookup_function(fqn)
        if fndef is not None and owner is not None:
            return self.summarize(fndef, owner, args, kwargs, env)
        return None

    def _np_call(self, tail: str, node, args, kwargs, env: Env):
        if tail in _CTORS:
            # numpy's and torch's (shape) form, and torch's (*dims) form
            if not args or len(args) == 1 or tail == "full" or (
                    isinstance(args[0], tuple)
                    and not isinstance(args[0], (SVal, AVal))):
                shape = args[0] if args else None
            else:
                shape = tuple(args)
            dims = _as_dims(shape)
            if dims is not None:
                return AVal(tuple(dims), fresh_atom(f"np.{tail}"))
            return unknown_aval(f"np.{tail}")
        if tail in _LIKE_CTORS:
            if args and isinstance(args[0], AVal) and args[0].dims:
                return AVal(args[0].dims, fresh_atom(f"np.{tail}"),
                            args[0].exact)
            return unknown_aval(f"np.{tail}")
        if tail == "pad":
            arr = args[0] if args else None
            pads = node.args[1] if len(node.args) > 1 else None
            if isinstance(arr, AVal) and arr.dims and \
                    isinstance(pads, (ast.Tuple, ast.List)) and \
                    len(pads.elts) == len(arr.dims):
                dims = []
                for d, p in zip(arr.dims, pads.elts):
                    if isinstance(p, (ast.Tuple, ast.List)) and \
                            len(p.elts) == 2:
                        lo = self.eval(p.elts[0], env, hook=False)
                        hi = self.eval(p.elts[1], env, hook=False)
                        if isinstance(lo, SVal) and isinstance(hi, SVal) \
                                and d.sym and lo.sym and hi.sym:
                            iv = env.iv_of(d).add(env.iv_of(lo)) \
                                .add(env.iv_of(hi))
                            dims.append(SVal(iv.meet(NONNEG),
                                             s_add(d.sym,
                                                   s_add(lo.sym, hi.sym))))
                            continue
                    dims.append(unknown_sval("paddim"))
                return AVal(tuple(dims), fresh_atom("np.pad"))
            return unknown_aval("np.pad")
        if tail in _PASSTHRU:
            if args and isinstance(args[0], AVal):
                return args[0]
            if args and isinstance(args[0], SVal):
                base = args[0].sym or fresh_atom("asarray")
                return AVal((), ("call", "asarray", (base,)))
            return unknown_aval(tail)
        if tail in _ELEMWISE:
            for a in args:
                if isinstance(a, AVal):
                    return AVal(a.dims, fresh_atom(f"np.{tail}"), a.exact)
            return unknown_sval(tail)
        if tail in ("iinfo", "finfo"):
            return ("iinfo", args[0] if args else None)
        if tail in ("int64", "int32"):
            return args[0] if args and isinstance(args[0], SVal) \
                else unknown_sval(tail)
        if tail in ("searchsorted", "cumsum", "arange", "nonzero",
                    "bincount", "concatenate", "stack"):
            return unknown_aval(f"np.{tail}")
        return unknown_sval(f"np.{tail}")

    def _attribute(self, node: ast.Attribute, env: Env, hook: bool):
        # np.iinfo(np.int32).max -> 2**31 - 1
        if node.attr in ("max", "min") and isinstance(node.value, ast.Call):
            inner = self.eval(node.value, env, hook=False)
            if isinstance(inner, tuple) and len(inner) == 2 and \
                    inner[0] == "iinfo":
                bits = _dtype_bits(node.value)
                if bits:
                    v = 2 ** (bits - 1) - 1 if node.attr == "max" \
                        else -(2 ** (bits - 1))
                    return SVal(const_iv(v), s_const(v))
        base = self.eval(node.value, env, hook=False)
        if isinstance(base, LibRef):
            return EntryRef(frozenset({(base.kernel, node.attr)}))
        if node.attr == "shape":
            return ShapeRef(base, node.value.id
                            if isinstance(node.value, ast.Name) else None)
        if isinstance(base, AVal):
            if node.attr == "size":
                if base.dims and all(isinstance(d, SVal) and d.sym
                                     for d in base.dims):
                    sym = s_const(1)
                    iv = const_iv(1)
                    for d in base.dims:
                        sym = s_mul(sym, d.sym)
                        iv = iv.mul(env.iv_of(d).meet(NONNEG))
                    return SVal(iv, sym)
                return SVal(NONNEG, s_atom(("size", base.sym)))
            if node.attr == "T":
                return base
            if node.attr == "at":
                return AtRef(base)
            if node.attr == "dtype":
                return unknown_sval("dtype")
        # module-level constant via import (e.g. other_mod._I32_MAX)
        from .modules import dotted
        parts = dotted(node)
        if parts is not None:
            fqn = self.index.resolve(self.module, ".".join(parts))
            owner, cexpr = self.index.lookup_constant(fqn)
            if cexpr is not None and owner is not None and \
                    owner is not self.module:
                sub = FlowInterp(self.index, owner, max_paths=8,
                                 depth=self.depth + 1)
                return sub.eval(cexpr, sub.module_env(), hook=False)
        if isinstance(base, SVal) and base.sym:
            return SVal(TOP, s_atom(("attr", base.sym, node.attr)))
        return unknown_sval(f"attr:{node.attr}")

    def _subscript(self, node: ast.Subscript, env: Env, hook: bool):
        base = self.eval(node.value, env, hook)
        sl = node.slice
        if isinstance(base, AtRef):
            return base.aval
        if isinstance(base, ShapeRef):
            rank = None
            if isinstance(sl, ast.Constant) and isinstance(sl.value, int):
                rank = sl.value + 1
            if rank is not None:
                aval = self._materialize(node.value.value, env, rank=rank) \
                    if isinstance(node.value, ast.Attribute) else None
                if aval is not None and len(aval.dims) >= rank:
                    return aval.dims[rank - 1]
            return unknown_sval("shape")
        if isinstance(base, AVal) and base.dims:
            if isinstance(sl, ast.Slice):
                return AVal((self._slice_dim(base.dims[0], sl, env),)
                            + base.dims[1:], fresh_atom("slice"), base.exact)
            if isinstance(sl, ast.Tuple):
                dims = list(base.dims)
                out = []
                for i, s in enumerate(sl.elts):
                    if i >= len(dims):
                        break
                    if isinstance(s, ast.Slice):
                        out.append(self._slice_dim(dims[i], s, env))
                    # plain index drops the dim
                return AVal(tuple(out) + tuple(dims[len(sl.elts):]),
                            fresh_atom("slice"), base.exact)
            if isinstance(sl, ast.Constant) or isinstance(sl, ast.Name):
                return AVal(base.dims[1:], fresh_atom("index"), base.exact) \
                    if len(base.dims) > 1 else unknown_sval("elt")
        if isinstance(base, tuple) and not isinstance(base, (SVal, AVal)) \
                and isinstance(sl, ast.Constant) and \
                isinstance(sl.value, int) and sl.value < len(base):
            return base[sl.value]
        return unknown_sval("sub")

    def _slice_dim(self, dim: SVal, sl: ast.Slice, env: Env) -> SVal:
        if sl.lower is None and sl.step is None and sl.upper is not None:
            up = self.eval(sl.upper, env, hook=False)
            if isinstance(up, SVal):
                upi = env.iv_of(up).meet(NONNEG)
                # x[:n] has dim min(len, n); equals n when 0 <= n <= len
                if up.sym is not None and dim.sym is not None:
                    diff = env.sym_iv(s_sub(dim.sym, up.sym))
                    if diff.lo >= 0 and upi.lo >= 0:
                        return SVal(upi, up.sym)
                return SVal(IV(0, min(env.iv_of(dim).hi, upi.hi)),
                            ("min", tuple(sorted((dim.sym, up.sym),
                                                 key=repr)))
                            if dim.sym and up.sym else None)
        if sl.lower is None and sl.upper is None and sl.step is None:
            return dim
        return unknown_sval("dim")

    # --- condition refinement ----------------------------------------------

    def refine_cond(self, test, env: Env, truth: bool) -> None:
        try:
            self._refine(test, env, truth)
        except Exception:
            pass

    def _refine(self, test, env: Env, truth: bool) -> None:
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self._refine(test.operand, env, not truth)
        if isinstance(test, ast.BoolOp):
            if (isinstance(test.op, ast.And) and truth) or \
                    (isinstance(test.op, ast.Or) and not truth):
                for v in test.values:
                    self._refine(v, env, truth)
            return
        if isinstance(test, ast.Name):
            val = env.vars.get(test.id)
            if isinstance(val, SVal):
                iv = IV(0, 0) if not truth else (
                    IV(1, INF) if env.iv_of(val).lo >= 0 else TOP)
                nv = SVal(env.iv_of(val).meet(iv), val.sym)
                env.vars[test.id] = nv
                if val.sym:
                    env.meet_sym(val.sym, nv.iv)
            return
        if isinstance(test, ast.Compare) and len(test.ops) > 1:
            # a <= b < c holds as its pairs; its negation is a disjunction
            if truth:
                terms = [test.left, *test.comparators]
                for i, op in enumerate(test.ops):
                    self._refine(ast.Compare(left=terms[i], ops=[op],
                                             comparators=[terms[i + 1]]),
                                 env, True)
            return
        if not isinstance(test, ast.Compare) or len(test.ops) != 1:
            return
        op = test.ops[0]
        left, right = test.left, test.comparators[0]
        if not truth:
            op = _NEG.get(type(op))
            if op is None:
                return
        else:
            op = type(op)
        if op in (ast.Eq,) and self._refine_shape_eq(left, right, env):
            return
        lv = self.eval(left, env, hook=False)
        rv = self.eval(right, env, hook=False)
        if isinstance(lv, SVal) and isinstance(rv, SVal):
            self._refine_rel(lv, op, env.iv_of(rv), env)
            self._refine_rel(rv, _FLIP[op], env.iv_of(lv), env)

    def _refine_rel(self, val: SVal, op, other: IV, env: Env) -> None:
        if op is ast.Lt and other.hi != INF:
            bound = IV(-INF, other.hi - 1)
        elif op is ast.LtE and other.hi != INF:
            bound = IV(-INF, other.hi)
        elif op is ast.Gt and other.lo != -INF:
            bound = IV(other.lo + 1, INF)
        elif op is ast.GtE and other.lo != -INF:
            bound = IV(other.lo, INF)
        elif op is ast.Eq:
            bound = other
        else:
            return
        if val.sym is None:
            return
        env.meet_sym(val.sym, bound)
        self._record_bound(val.sym, bound, env)
        if val.sym[0] == "min" and bound.lo > -INF:
            # min(a, b) >= L bounds both from below
            for a in val.sym[1]:
                env.meet_sym(a, IV(bound.lo, INF))
        if val.sym[0] == "+" and len(val.sym[2]) == 1 and \
                val.sym[2][0][1] == 1 and bound.lo > -INF:
            # x + c >= L puts x >= L - c (the upper side: _record_bound)
            env.meet_sym(val.sym[2][0][0], IV(bound.lo - val.sym[1], INF))

    def _record_bound(self, sym, bound: IV, env: Env,
                      depth: int = 0) -> None:
        """Product bounds + max-splitting: ``max(a, b) <= H`` bounds both;
        ``a * b <= H`` is recorded as a factor-multiset bound."""
        if depth > 4 or not bound.hi < INF:
            return
        if sym[0] == "+" and len(sym[2]) == 1 and sym[2][0][1] == 1:
            # x + c <= H puts x <= H - c
            t, c = sym[2][0][0], sym[1]
            env.meet_sym(t, IV(-INF, bound.hi - c))
            self._record_bound(t, IV(-INF, bound.hi - c), env, depth + 1)
            return
        if sym[0] == "max":
            for a in sym[1]:
                env.meet_sym(a, IV(-INF, bound.hi))
                self._record_bound(a, bound, env, depth + 1)
            return
        coeff, fs = s_factors(sym)
        if len(fs) >= 2 and coeff >= 1:
            env.prods.append((fs, bound.hi // coeff))

    def _refine_shape_eq(self, left, right, env: Env) -> bool:
        """x.shape == (a, b, ...) and x.shape == y.shape refinements
        (``tuple(x.shape)`` is x.shape)."""
        left, right = _untuple(left), _untuple(right)
        if isinstance(right, ast.Attribute) and right.attr == "shape" and \
                not (isinstance(left, ast.Attribute)
                     and left.attr == "shape"):
            left, right = right, left
        if not (isinstance(left, ast.Attribute) and left.attr == "shape"):
            return False
        if isinstance(right, (ast.Tuple, ast.List)):
            dims = []
            ok = True
            for el in right.elts:
                v = self.eval(el, env, hook=False)
                if isinstance(v, SVal):
                    if v.sym is not None:
                        env.meet_sym(v.sym, NONNEG)
                    dims.append(SVal(env.iv_of(v).meet(NONNEG), v.sym))
                else:
                    ok = False
                    break
            if ok and isinstance(left.value, ast.Name):
                prev = env.vars.get(left.value.id)
                sym = prev.sym if isinstance(prev, (AVal, SVal)) and \
                    prev.sym else fresh_atom("arr")
                env.vars[left.value.id] = AVal(tuple(dims), sym)
                return True
        if isinstance(right, ast.Attribute) and right.attr == "shape":
            rv = self.eval(right.value, env, hook=False)
            if isinstance(rv, AVal) and rv.dims and \
                    isinstance(left.value, ast.Name):
                prev = env.vars.get(left.value.id)
                sym = prev.sym if isinstance(prev, (AVal, SVal)) and \
                    prev.sym else fresh_atom("arr")
                env.vars[left.value.id] = AVal(rv.dims, sym, rv.exact)
                return True
        return False


_NEG = {ast.Lt: ast.GtE, ast.LtE: ast.Gt, ast.Gt: ast.LtE,
        ast.GtE: ast.Lt, ast.Eq: ast.NotEq, ast.NotEq: ast.Eq}
_FLIP = {ast.Lt: ast.Gt, ast.LtE: ast.GtE, ast.Gt: ast.Lt,
         ast.GtE: ast.LtE, ast.Eq: ast.Eq, ast.NotEq: ast.NotEq}


def _params(fn) -> list[str]:
    return _param_list(fn)


def _param_list(fn) -> list[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def _untuple(node):
    """``tuple(x.shape)`` -> ``x.shape``; anything else as is."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and \
            node.func.id == "tuple" and len(node.args) == 1 and \
            not node.keywords and isinstance(node.args[0], ast.Attribute) \
            and node.args[0].attr == "shape":
        return node.args[0]
    return node


def _size_of(base, env: Env) -> SVal:
    """Element count of an array (the product of its dims when known), or
    of a not yet materialized value (one ``size`` atom of its symbol)."""
    if isinstance(base, AVal) and base.dims and base.exact and \
            all(isinstance(d, SVal) and d.sym for d in base.dims):
        sym = s_const(1)
        iv = const_iv(1)
        for d in base.dims:
            sym = s_mul(sym, d.sym)
            iv = iv.mul(env.iv_of(d).meet(NONNEG))
        return SVal(iv, sym)
    key = base.sym if isinstance(base, (AVal, SVal)) and base.sym \
        else fresh_atom("arr")
    return SVal(NONNEG, s_atom(("size", key)))


def _dtype_bits(call: ast.Call) -> Optional[int]:
    """Bit width named by an ``iinfo(np.int32)``-style argument."""
    if not call.args:
        return None
    arg = call.args[0]
    name = None
    if isinstance(arg, ast.Attribute):
        name = arg.attr
    elif isinstance(arg, ast.Name):
        name = arg.id
    elif isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        name = arg.value
    if name and name.startswith("int") and name[3:].isdigit():
        return int(name[3:])
    if name and name.startswith("uint") and name[4:].isdigit():
        return int(name[4:]) + 1
    return None


def _syms(args: list) -> tuple:
    return tuple(a.sym if isinstance(a, (SVal, AVal)) else None
                 for a in args)


def _as_dims(shape) -> Optional[list]:
    if isinstance(shape, tuple) and not isinstance(shape, (SVal, AVal)):
        dims = []
        for d in shape:
            if not isinstance(d, SVal):
                return None
            dims.append(SVal(d.iv.meet(NONNEG), d.sym))
        return dims
    if isinstance(shape, SVal):
        return [SVal(shape.iv.meet(NONNEG), shape.sym)]
    return None


def _join_values(vals: list):
    vals = [v for v in vals if isinstance(v, (SVal, AVal))]
    if not vals:
        return unknown_sval("ret")
    if all(isinstance(v, AVal) for v in vals):
        first = vals[0]
        if all(len(v.dims) == len(first.dims) for v in vals):
            dims = []
            for i, d in enumerate(first.dims):
                ds = [v.dims[i] for v in vals]
                iv = ds[0].iv
                for x in ds[1:]:
                    iv = iv.join(x.iv)
                sym = d.sym if all(x.sym == d.sym for x in ds) else None
                dims.append(SVal(iv, sym))
            return AVal(tuple(dims), first.sym,
                        all(v.exact for v in vals))
        return unknown_aval("ret")
    if all(isinstance(v, SVal) for v in vals):
        iv = vals[0].iv
        sym = vals[0].sym
        for v in vals[1:]:
            iv = iv.join(v.iv)
            if v.sym != sym:
                sym = None
        return SVal(iv, sym)
    return unknown_sval("ret")


def _join_envs(envs: list[Env]) -> Env:
    out = envs[0]
    for e in envs[1:]:
        for k, v in list(out.vars.items()):
            ov = e.vars.get(k)
            if isinstance(v, SVal) and isinstance(ov, SVal):
                out.vars[k] = SVal(v.iv.join(ov.iv),
                                   v.sym if v.sym == ov.sym else None)
            elif isinstance(v, AVal) and isinstance(ov, AVal) and \
                    v.dims == ov.dims:
                pass
            elif isinstance(v, (LibRef, EntryRef)) and v == ov:
                pass
            elif ov is not v:
                out.vars[k] = unknown_sval(f"join:{k}")
        out.refine = {k: iv.join(e.refine[k])
                      for k, iv in out.refine.items() if k in e.refine}
        out.prods = [p for p in out.prods if p in e.prods]
    return out

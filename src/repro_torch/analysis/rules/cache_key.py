"""cache-key: everything that can reach a cached value must reach its key.

A memoized result that depends on an input the key omits silently serves
the wrong answer when that input changes — the exact bug class the BNA /
order LRU key-hardening fixed by hand.  This rule finds every *caching
function* (a body containing both ``<cache>.lookup(K)`` and
``<cache>.store(K, V)`` on the same cache-named object) and checks two
obligations:

1. **Parameter soundness** — every function parameter that can reach the
   stored value ``V`` (flow-insensitive def-use closure over the body,
   with ``zip``/``enumerate`` unpack precision) must also reach the
   stored key ``K`` — except the port's dispatch selectors ``device`` and
   ``plan_backend``: they are the parameters the reference's backend knobs
   became, and the same certification makes them neutral (the port's
   tests hold every value equal across devices and plan backends).
2. **Knob soundness** — the call graph is walked from the caching
   function (bounded BFS); any environment read (``os.environ``,
   ``os.getenv``: the port has no ``REPRO_*`` knobs, so every one is a
   hidden input) or ``config.<attr>`` read reachable from the value
   computation is reported — unless the function sits in the *neutral
   set*: the ``core/backend.py`` dispatchers, whose device and plan
   backend branches are held bit-identical by the port's tests (card =
   CPU, python = pipeline), so what they select cannot change the cached
   value; or the attr is cache plumbing (``*_cache_size`` bounds
   eviction, not results).
"""
from __future__ import annotations

import ast

from .. import ProgramContext, register_rule
from ..flow.callgraph import CallGraph, find_knob_reads
from ._util import dotted

# Dispatch helpers whose device and plan-backend branches are held
# bit-identical by the port's tests (card = CPU, python = pipeline): a read
# below these selects *how* a value is computed, never *what* it is.  The
# port's core/matching.py has no counterpart of the reference's
# _resolve_step, so it adds none.
_NEUTRAL_FQNS = {
    "repro_torch.core.backend.compute_alphas",
    "repro_torch.core.backend.resolve_plan_backend",
    "repro_torch.core.backend.prefetch_plan",
    "repro_torch.core.backend.plan_edges",
    "repro_torch.core.backend.plan_order_loads",
    "repro_torch.core.backend.fixup_pieces",
    "repro_torch.core.backend.fused_merge_fix",
    "repro_torch.core.backend.bna_pieces",
    "repro_torch.core.backend.bna_pieces_many",
    "repro_torch.core.backend.prefetch_bna",
}

# the port's dispatch selectors: parameters where the reference reads knobs
_NEUTRAL_PARAMS = {"device", "plan_backend"}

# config attributes that bound cache capacity, not cached results
_CACHE_PLUMBING_ATTRS = {"bna_cache_size", "order_cache_size",
                         "edge_cache_size", "compile_cache_size",
                         "group_cache_size", "loads_cache_size",
                         "gkey_cache_size"}

_HINT_PARAM = ("fold the parameter into the cache key (or derive both key "
               "and value from the same inputs); a value-only input makes "
               "the memo serve stale results when it changes")
_HINT_KNOB = ("include the knob in the cache key, clear the cache when it "
              "changes, or — if every setting is certified bit-identical — "
              "add the dispatcher to the rule's neutral set with that "
              "justification")


def _cache_calls(fn: ast.AST):
    """(lookups, stores) on cache-named objects inside `fn`."""
    lookups, stores = [], []
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        parts = dotted(node.func.value)
        if parts is None or not any("cache" in p.lower() for p in parts):
            continue
        if node.func.attr == "lookup" and node.args:
            lookups.append(node)
        elif node.func.attr == "store" and len(node.args) >= 2:
            stores.append(node)
    return lookups, stores


def _load_names(expr: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(expr)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


def _name_deps(fn: ast.AST) -> dict[str, set[str]]:
    """Flow-insensitive name -> names-it-was-computed-from map."""
    deps: dict[str, set[str]] = {}

    def add(name: str, srcs: set[str]) -> None:
        deps.setdefault(name, set()).update(srcs - {name})

    def unpack(target: ast.expr, value: ast.expr | None) -> None:
        srcs = _load_names(value) if value is not None else set()
        if isinstance(target, (ast.Tuple, ast.List)) and \
                isinstance(value, ast.Call) and \
                isinstance(value.func, ast.Name) and \
                value.func.id in ("zip", "enumerate"):
            # positional precision: zip elt i <- arg i; enumerate elt 0
            # is the index (no deps), elt 1 <- the iterable
            args = value.args
            if value.func.id == "enumerate":
                args = [None] + list(args)
            for i, el in enumerate(target.elts):
                el_srcs = _load_names(args[i]) if i < len(args) and \
                    args[i] is not None else set()
                for n in ast.walk(el):
                    if isinstance(n, ast.Name):
                        add(n.id, el_srcs)
            return
        for n in ast.walk(target):
            if isinstance(n, ast.Name):
                add(n.id, srcs)

    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                unpack(t, node.value)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            unpack(node.target, node.value)
        elif isinstance(node, ast.AugAssign):
            unpack(node.target, node.value)
        elif isinstance(node, ast.For):
            unpack(node.target, node.iter)
        elif isinstance(node, ast.comprehension):
            unpack(node.target, node.iter)
        elif isinstance(node, ast.withitem) and \
                node.optional_vars is not None:
            unpack(node.optional_vars, node.context_expr)
        elif isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            # mutation-style accumulation: xs.append(y) makes xs carry y
            call = node.value
            if isinstance(call.func, ast.Attribute) and \
                    isinstance(call.func.value, ast.Name) and \
                    call.func.attr in ("append", "extend", "add",
                                       "update", "insert", "setdefault"):
                srcs: set[str] = set()
                for a in list(call.args) + [k.value for k in call.keywords]:
                    srcs |= _load_names(a)
                add(call.func.value.id, srcs)
    return deps


def _reach(names: set[str], deps: dict[str, set[str]]) -> set[str]:
    out = set(names)
    frontier = list(names)
    while frontier:
        n = frontier.pop()
        for src in deps.get(n, ()):
            if src not in out:
                out.add(src)
                frontier.append(src)
    return out


def _params(fn: ast.AST) -> set[str]:
    a = fn.args
    names = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
    if a.vararg:
        names.add(a.vararg.arg)
    if a.kwarg:
        names.add(a.kwarg.arg)
    return names


@register_rule("cache-key",
               "every parameter and global knob that can reach a cached "
               "value must also reach its cache key",
               scope="program")
def _cache_key(ctx: ProgramContext):
    index = ctx.index
    graph = CallGraph(index)
    seen_knobs: set[tuple] = set()
    for fc in ctx.files:
        if fc.in_testing() or fc.in_benchmarks():
            continue
        mi = index.by_rel.get(fc.rel)
        if mi is None or not mi.name.startswith("repro_torch."):
            continue
        for fname, fn in mi.functions.items():
            lookups, stores = _cache_calls(fn)
            if not (lookups and stores):
                continue
            fqn = f"{mi.name}.{fname}"
            deps = _name_deps(fn)
            params = _params(fn)
            for store in stores:
                key_expr, val_expr = store.args[0], store.args[1]
                key_reach = _reach(_load_names(key_expr), deps)
                val_reach = _reach(_load_names(val_expr), deps)
                leaked = sorted((val_reach - key_reach) & params
                                - _NEUTRAL_PARAMS)
                if leaked:
                    yield fc.finding(
                        "cache-key", store,
                        f"{fname}() caches a value computed from "
                        f"parameter(s) {', '.join(repr(p) for p in leaked)}"
                        f" that never reach the cache key", _HINT_PARAM)
            # knob soundness: env/config reads reachable from the body
            if fqn in _NEUTRAL_FQNS:
                continue
            reached = graph.reachable([fqn], max_depth=6,
                                      stop=_NEUTRAL_FQNS)
            for rfqn in sorted(reached):
                if rfqn in _NEUTRAL_FQNS:
                    continue
                owner, rfn = index.lookup_function(rfqn)
                if owner is None or rfn is None:
                    continue
                for read in find_knob_reads(rfn, owner, index):
                    if read.kind == "config" and \
                            read.name in _CACHE_PLUMBING_ATTRS:
                        continue
                    sig = (owner.ctx.rel, read.line, read.name)
                    if sig in seen_knobs:
                        continue
                    seen_knobs.add(sig)
                    where = "" if rfqn == fqn else \
                        f" (via {rfqn.rsplit('.', 1)[-1]}())"
                    yield owner.ctx.finding(
                        "cache-key", read.line,
                        f"{fname}() populates a cache but reads "
                        f"result-affecting knob "
                        f"{read.name!r}{where} that is not part of the "
                        f"cache key", _HINT_KNOB)
"""Kernel entry points and compute caches for the scheduler engine — the
port of ``repro.core.backend``.

Dispatch is by device and by an explicit plan backend, never by a knob
read from the environment.  Every entry point takes ``device`` (default
``"cuda"``): on a card the kernels run, with ``device="cpu"`` their plain
PyTorch versions.  Both give the same integers, so plans are
bit-identical.  The plan backend (:func:`resolve_plan_backend`) picks the
planning path, as the reference's ``use_plan_backend`` does:

* ``"python"`` — the per-coflow path: ``bna_many`` (``kernels/bna_step``
  per lock-step step, host augmenting-path repair) and
  :func:`compute_alphas` (``kernels/coflow_merge``);
* ``"pipeline"`` — ``core/pipeline.py`` (the reference's ``jit``): one
  ``kernels/bna_decompose`` call per width bucket, step and repair, behind
  :func:`prefetch_plan` / :func:`plan_edges`, the device segment sum behind
  :func:`plan_order_loads`, the fused ``kernels/merge_fix`` behind
  :func:`fused_merge_fix`, and the fix-up's batch of interval demands
  behind :func:`fixup_pieces`.

Its default follows the device: ``"pipeline"`` on a card (the reference
resolves ``auto`` to ``jit`` on its accelerator), ``"python"`` on the
CPU.  Nothing falls back: a kernel that fails to build or launch raises.

Caches, with the reference's key discipline:

* **BNA cache** — a bounded LRU keyed on ``(shape, dtype, bytes)`` of the
  demand, memoizing BNA decompositions (Algorithm 1).
  :func:`bna_pieces_many` is the batch entry: it consults the LRU first and
  hands ONLY the misses to ``bna_many`` in one batched call — this is what
  the engine's instance-level prefetch goes through.  A miss in
  :func:`bna_pieces` (the walk's per-coflow lookup) also goes through
  ``bna_many`` on the device, so every decomposition on the planning path
  runs the ``bna_step`` kernel on a card, whatever the cache holds.
* **edge cache** — the pipeline's start-relative edge intervals per demand
  (``pipeline.edge_cache``), keyed like the BNA cache.
* **order cache** — the primal-dual job order (Algorithm 5), keyed on the
  exact scheduling state (``ordering.instance_signature``).
* **group-block cache** — spread-mode G-DM / G-DM-RT group parts built at
  origin 0, keyed on the construction's full input.  Spread-mode layouts
  are deterministic and translation invariant in the origin, so
  ``group_block(...).shifted_expanded(start)`` is bit-identical to
  rebuilding the group at ``start``.  Randomized delay modes are never
  cached (their layouts consume rng draws).
* **loads / grouping-key caches** — per-job Algorithm 5 load vectors keyed
  on demand bytes, and the geometric-grouping prefix-load cumsum keyed on
  the ordered demand signature, extended incrementally when a cached
  prefix of the order exists.

The device is not part of any key: a cached value is the same on every
device (the equality checks in ``tests/test_torch_*.py`` and
``chip_smoke.py`` hold the two paths to it).

The cache bounds are the reference's defaults, fixed on the cache objects.
No environment variable is read.
"""
from __future__ import annotations

from collections import OrderedDict
from contextlib import contextmanager
from typing import Iterable

import numpy as np
import torch

from ..kernels.coflow_merge import edge_interval_alphas
from ..kernels.merge_fix import merge_fix_step
from . import matching

__all__ = [
    "PLAN_BACKENDS",
    "resolve_plan_backend",
    "prefetch_plan",
    "plan_edges",
    "plan_order_loads",
    "fused_merge_fix",
    "fixup_pieces",
    "compute_alphas",
    "bna_pieces",
    "bna_pieces_many",
    "prefetch_bna",
    "group_block",
    "grouping_prefix",
    "cache_stats",
    "clear_caches",
    "no_caches",
]


def compute_alphas(events: np.ndarray, edges, m: int,
                   device: "str | torch.device" = "cuda") -> np.ndarray:
    """Per-interval alphas (max per-port packet count) for merge_and_fix.

    `edges` is a timeline.EdgeIntervals; `events` the sorted unique interval
    boundaries.  Runs the coflow_merge kernel on a card, its plain version
    on the CPU."""
    K = int(events.size) - 1
    if K <= 0:
        return np.zeros(0, dtype=np.int64)
    if edges.size == 0:
        return np.zeros(K, dtype=np.int64)
    return edge_interval_alphas(events, edges.t0, edges.t1, edges.s,
                                edges.r, m, device=device)


# --------------------------------------------------------------------------
# plan backend dispatch (the reference's REPRO_PLAN_BACKEND; core/pipeline.py)
# --------------------------------------------------------------------------

PLAN_BACKENDS = ("python", "pipeline")


def resolve_plan_backend(plan_backend: "str | None",
                         device: "str | torch.device") -> str:
    """The planning path of a call: ``plan_backend`` when given, else the
    device's default (``"pipeline"`` on a card, ``"python"`` on the
    CPU)."""
    if plan_backend is None:
        return "pipeline" if torch.device(device).type == "cuda" \
            else "python"
    if plan_backend not in PLAN_BACKENDS:
        raise ValueError(f"unknown plan backend {plan_backend!r}; "
                         f"expected one of {PLAN_BACKENDS}")
    return plan_backend


def prefetch_plan(demands: "Iterable[np.ndarray]",
                  plan_backend: "str | None" = None,
                  device: "str | torch.device" = "cuda") -> None:
    """Instance-level prefetch on the plan backend: under ``"pipeline"``
    it warms the BNA *and* edge-interval caches through the
    width-bucketed sweep (``pipeline.prefetch_demands``); under
    ``"python"`` it is exactly :func:`prefetch_bna`."""
    ds = list(demands)
    if resolve_plan_backend(plan_backend, device) == "pipeline":
        from . import pipeline

        pipeline.prefetch_demands(ds, device=device)
        return
    prefetch_bna(ds, device=device)


def plan_edges(demand: np.ndarray, plan_backend: "str | None" = None,
               device: "str | torch.device" = "cuda"):
    """Relative (t0, t1, s, r) edge intervals of one coflow's BNA schedule
    under the ``"pipeline"`` backend; None routes the caller to the python
    path."""
    if resolve_plan_backend(plan_backend, device) != "pipeline":
        return None
    from . import pipeline

    return pipeline.coflow_edges_rel(demand, device=device)


def plan_order_loads(instance, plan_backend: "str | None" = None,
                     device: "str | torch.device" = "cuda"):
    """Algorithm 5 load vectors from the device segment sum (bit-identical
    integer sums) under ``"pipeline"``; None routes the caller to the host
    computation."""
    if resolve_plan_backend(plan_backend, device) != "pipeline":
        return None
    from . import pipeline

    return pipeline.instance_load_vectors(instance, device=device)


def fixup_pieces(subs: list, plan_backend: "str | None" = None,
                 device: "str | torch.device" = "cuda") -> list:
    """BNA pieces of merge_and_fix's fix-up demands (each interval's merged
    demand, support-restricted; ``timeline._decompose``) in one batch on
    `device`: ``pipeline.decompose_pieces`` (``bna_decompose`` per width
    bucket) under ``"pipeline"``, ``matching.bna_many`` (``bna_step`` and
    the host repair) under ``"python"``.  Each list is bit-identical to
    the scalar ``bna`` of its matrix.  Nothing is cached: the fix-up's
    demands are decomposed uncached, as in the reference."""
    from . import pipeline

    pipeline._fixup["batches"] += 1
    pipeline._fixup["lanes"] += len(subs)
    if resolve_plan_backend(plan_backend, device) == "pipeline":
        return pipeline.decompose_pieces(subs, device=device)
    return matching.bna_many(subs, device=device)


def fused_merge_fix(events: np.ndarray, edges, m: int,
                    plan_backend: "str | None" = None,
                    device: "str | torch.device" = "cuda"):
    """(alphas, expansion deltas) in one call on `device` through the fused
    ``kernels/merge_fix`` step (its plain version on the CPU) under
    ``"pipeline"``.  None routes the caller to the two-stage path (also
    for an empty merge).  Bit-identical: integer counts and int64
    durations."""
    if resolve_plan_backend(plan_backend, device) != "pipeline":
        return None
    if not (edges.size and events.size > 1):
        return None
    return merge_fix_step(events, edges.t0, edges.t1, edges.s, edges.r, m,
                          device=device)


# --------------------------------------------------------------------------
# bounded LRU caches with hit/miss counters
# --------------------------------------------------------------------------

class LRUCache:
    """Tiny bounded LRU with hit/miss counters; maxsize <= 0 disables."""

    def __init__(self, maxsize: int, name: str):
        self.name = name
        self.maxsize = maxsize
        self._od: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def lookup(self, key):
        """(found, value); counts a hit/miss and refreshes recency."""
        if self.maxsize <= 0:
            self.misses += 1
            return False, None
        try:
            val = self._od[key]
        except KeyError:
            self.misses += 1
            return False, None
        self._od.move_to_end(key)
        self.hits += 1
        return True, val

    def peek(self, key):
        """(found, value) WITHOUT touching counters or recency — for
        secondary probes (the grouping-key prefix scan)."""
        if self.maxsize <= 0 or key not in self._od:
            return False, None
        return True, self._od[key]

    def store(self, key, val) -> None:
        if self.maxsize <= 0:
            return
        self._od[key] = val
        self._od.move_to_end(key)
        while len(self._od) > self.maxsize:
            self._od.popitem(last=False)

    def __len__(self) -> int:
        return len(self._od)

    def clear(self) -> None:
        self._od.clear()
        self.hits = 0
        self.misses = 0

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {"hits": self.hits, "misses": self.misses,
                "size": len(self._od),
                "hit_rate": (self.hits / total) if total else 0.0}


bna_cache = LRUCache(4096, "bna")
edge_cache = LRUCache(4096, "plan_edges")
order_cache = LRUCache(256, "order")
group_cache = LRUCache(512, "group")
loads_cache = LRUCache(4096, "loads")
gkey_cache = LRUCache(512, "gkey")

# per-batch counters for bna_pieces_many: batched lookups, and how their
# members split into cache hits, misses handed to the batched
# decomposition (unique demands), and in-batch duplicates
_bna_batch = {"batches": 0, "hits": 0, "misses": 0, "deduped": 0}


def _bna_key(demand: np.ndarray) -> tuple:
    """BNA cache key: (shape, dtype, bytes), so demands that share a byte
    string across dtypes/shapes can neither collide nor hit each other."""
    return (demand.shape, demand.dtype.str, demand.tobytes())


def bna_pieces(demand: np.ndarray,
               device: "str | torch.device" = "cuda") -> list:
    """BNA decomposition of `demand`, memoized on (shape, dtype, bytes).
    A miss runs ``bna_many`` on `device` for this one demand (the
    reference runs its scalar host ``bna`` there; the pieces are the
    same), so the ``bna_step`` kernel decomposes it on a card even when
    :func:`prefetch_bna` could not batch the instance.

    The returned pieces are shared across callers and read-only."""
    key = _bna_key(demand)
    found, pieces = bna_cache.lookup(key)
    if not found:
        pieces = matching.bna_many([demand], device=device)[0]
        bna_cache.store(key, pieces)
    return pieces


def bna_pieces_many(demands: list, keys: list | None = None,
                    device: "str | torch.device" = "cuda") -> list:
    """BNA decompositions for a batch of demands: the LRU is consulted
    first, and ONLY the misses (deduplicated) go through the batched
    ``bna_many`` on `device` in a single call.  Bit-identical to
    ``[bna_pieces(d) for d in demands]``.  ``keys`` accepts precomputed
    ``_bna_key`` values (same order as ``demands``)."""
    out: list = [None] * len(demands)
    miss_keys: list = []
    miss_demands: list = []
    by_key: dict = {}
    hits = 0
    for i, dem in enumerate(demands):
        key = _bna_key(dem) if keys is None else keys[i]
        found, pieces = bna_cache.lookup(key)
        if found:
            out[i] = pieces
            hits += 1
            continue
        slot = by_key.get(key)
        if slot is None:
            by_key[key] = [i]
            miss_keys.append(key)
            miss_demands.append(dem)
        else:
            slot.append(i)
    if miss_demands:
        many = matching.bna_many(miss_demands, device=device)
        for key, pieces in zip(miss_keys, many):
            bna_cache.store(key, pieces)
            for i in by_key[key]:
                out[i] = pieces
    _bna_batch["batches"] += 1
    _bna_batch["hits"] += hits
    _bna_batch["misses"] += len(miss_demands)
    _bna_batch["deduped"] += len(demands) - hits - len(miss_demands)
    return out


def prefetch_bna(demands: "Iterable[np.ndarray]",
                 device: "str | torch.device" = "cuda") -> None:
    """Warm the BNA cache for every demand in one batched call on `device`
    — the instance-level prefetch ``engine.plan`` issues before the
    schedulers walk jobs one by one.

    A no-op when the cache is disabled or the instance's distinct demands
    cannot all fit in the cache (a bigger batch would evict its own
    entries before the walk reads them); the walk's misses then go
    through ``bna_many`` on `device` one demand at a time."""
    if bna_cache.maxsize <= 0:
        return
    ds = list(demands)
    if not ds:
        return
    keys = [_bna_key(d) for d in ds]
    if len(set(keys)) > bna_cache.maxsize:
        return
    bna_pieces_many(ds, keys=keys, device=device)


# --------------------------------------------------------------------------
# spread-mode group-block cache (G-DM / G-DM-RT geometric groups)
# --------------------------------------------------------------------------

def _group_sig(jobs) -> tuple:
    """Per-job identity a spread-mode DMA/DMA-SRT layout is a function of:
    job id, weight and release, DAG edges, and per-coflow
    (cid, shape, dtype, bytes)."""
    return tuple(
        (int(j.jid), float(j.weight), int(j.release), tuple(j.edges),
         tuple((c.cid, c.demand.shape, c.demand.dtype.str,
                c.demand.tobytes()) for c in j.coflows))
        for j in jobs)


def group_block(kind: str, jobs, m: int, *, beta: float = 2.0,
                decompose: bool = False, nested: bool = True,
                require_tree: bool = True, delays: str = "spread",
                device: "str | torch.device" = "cuda",
                plan_backend: "str | None" = None):
    """One geometric group's DMA (kind="gdm") / DMA-RT (kind="gdm_rt")
    schedule built at **origin 0** on `device` and `plan_backend`, memoized
    on the construction's full input (the device and the plan backend are
    not part of the key: every one of them builds the same block).  Callers place the block with
    ``.shifted_expanded(start)``.  The returned FinalSchedule is shared
    and read-only.  Randomized delay modes are rejected."""
    from .dma import dma
    from .dma_srt import dma_rt

    if kind not in ("gdm", "gdm_rt"):
        raise ValueError(f"unknown group-block kind {kind!r}; "
                         f"choose from ('gdm', 'gdm_rt')")
    if delays != "spread":
        raise ValueError(
            f"group_block caches spread-mode layouts only (got "
            f"delays={delays!r}): randomized modes consume rng draws")
    key = (kind, int(m), float(beta), bool(decompose), bool(nested),
           bool(require_tree), delays) + _group_sig(jobs)
    found, part = group_cache.lookup(key)
    if not found:
        if kind == "gdm_rt":
            part = dma_rt(list(jobs), m, beta=beta, rng=None, origin=0,
                          decompose=decompose, nested=nested,
                          require_tree=require_tree, delays=delays,
                          device=device, plan_backend=plan_backend)
        else:
            part = dma(list(jobs), m, beta=beta, rng=None, origin=0,
                       decompose=decompose, delays=delays, device=device,
                       plan_backend=plan_backend)
        group_cache.store(key, part)
    return part


# --------------------------------------------------------------------------
# incremental Algorithm 5 grouping-key prefix (geometric grouping, step 2)
# --------------------------------------------------------------------------

# how far back the prefix probe scans for a cached prefix of the order
_GKEY_PREFIX_PROBES = 4

# exact hits / prefix extensions / cold recomputes (cache_stats()["gkey"])
_gkey_counts = {"exact": 0, "extended": 0, "cold": 0}


def _gkey_sig(job) -> tuple:
    """What a job contributes to the prefix-load cumsum: its per-coflow
    demands (the load vector is their row/column sums)."""
    return tuple((c.demand.shape, c.demand.dtype.str, c.demand.tobytes())
                 for c in job.coflows)


def grouping_prefix(instance, order: list) -> np.ndarray:
    """D_i for the geometric grouping (paper §VI step 2): the effective
    size of the aggregate coflow of the first i jobs of ``order`` — the
    max over 2m ports of the prefix cumsum of per-job load vectors.
    Memoized with incremental prefix extension; exact in float64 below
    2^53 (guarded).  Returns an int64 array aligned with ``order``."""
    from .ordering import job_load_vectors

    if not order:
        return np.zeros(0, dtype=np.int64)
    by_id = {j.jid: j for j in instance.jobs}
    m = instance.m
    sigs = tuple(_gkey_sig(by_id[jid]) for jid in order)
    key = (m,) + sigs
    found, val = gkey_cache.lookup(key)
    if found:
        _gkey_counts["exact"] += 1
        return val[1]
    n = len(order)
    base_row, base_D, start = None, None, 0
    for p in range(n - 1, max(n - 1 - _GKEY_PREFIX_PROBES, 0), -1):
        hit, pv = gkey_cache.peek((m,) + sigs[:p])
        if hit:
            base_row, base_D, start = pv[0], pv[1], p
            break
    _gkey_counts["extended" if base_row is not None else "cold"] += 1
    rows = job_load_vectors([by_id[jid] for jid in order[start:]], m)
    cum = np.cumsum(rows, axis=0)
    if base_row is not None:
        cum += base_row
    if cum.size and float(cum[-1].max()) >= 2.0**53:
        raise ValueError(
            "prefix load cumsum exceeds the float64 integer-exact "
            "range (2^53); the geometric grouping keys would be inexact")
    D_new = cum.max(axis=1).astype(np.int64)
    D = D_new if base_D is None else np.concatenate([base_D, D_new])
    last_row = cum[-1].copy() if cum.size else \
        (base_row if base_row is not None else np.zeros(2 * m))
    gkey_cache.store(key, (last_row, D))
    return D


def cache_stats() -> dict:
    from . import pipeline

    return {"bna": {**bna_cache.stats(), "batch": dict(_bna_batch),
                    **matching.stats},
            "order": order_cache.stats(),
            "group": group_cache.stats(),
            "loads": loads_cache.stats(),
            "gkey": {**gkey_cache.stats(), "prefix": dict(_gkey_counts)},
            "plan": pipeline.pipeline_stats()}


# every result memo this module owns — the single list clear_caches and
# no_caches iterate
_RESULT_CACHES = (bna_cache, edge_cache, order_cache, group_cache,
                  loads_cache, gkey_cache)


def clear_caches() -> None:
    from . import pipeline

    for cache in _RESULT_CACHES:
        cache.clear()
    for counts in (_bna_batch, _gkey_counts, matching.stats):
        for k in counts:
            counts[k] = type(counts[k])(0)
    pipeline.clear_pipeline_caches()


@contextmanager
def no_caches():
    """Disable (and clear) the result caches — the from-scratch
    comparator; restores them on exit."""
    saved = [(c.maxsize, dict(c._od), c.hits, c.misses)
             for c in _RESULT_CACHES]
    for c in _RESULT_CACHES:
        c.clear()
        c.maxsize = 0
    try:
        yield
    finally:
        for c, (maxsize, od, hits, misses) in zip(_RESULT_CACHES, saved):
            c.maxsize = maxsize
            c._od = OrderedDict(od)
            c.hits, c.misses = hits, misses

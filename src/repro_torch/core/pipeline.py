"""Planning pipeline — the port of ``repro.core.pipeline``, the plan
backend ``"pipeline"`` (the reference's ``jit``).

The hot half of a cold-start plan, the per-coflow BNA decomposition and
its run-length encoding into edge intervals, runs as one call per width
bucket on the plan's device:

1. **Padded buckets.**  Every demand is support-restricted exactly like the
   python path (``bna.support_restrict``), bucketed by padded width w
   (``matching.bucket_width``) and packed into a ``(B, w, w)`` int32 stack.
   Nothing is compiled per shape, so the batch is not padded: the
   reference's compile cache becomes a launch counter.
2. **One decomposition per bucket.**  ``kernels/bna_decompose`` runs the
   whole filled-matrix BNA of every lane, step and augmenting-path repair:
   one CUDA kernel on a card (one block per matrix), its plain version on
   the CPU.  Step stacks are bounded by ``T_cap = pow2(max nnz + 6w + 8)``,
   the python path's own termination guard, as in the reference.
3. **RLE on the device.**  The step stacks come back only as far as each
   lane's own step count; the edge intervals every scheduler consumes are
   extracted with one boundary scan over the whole bucket in torch ops on
   the device (``_rle_batch``) and cached per demand (``edge_cache``, the
   BNA cache's key discipline).  Within a coflow the rows are ordered by
   (sender, start time); every consumer is order-independent within a
   coflow, so plans are bit-identical to the python path's.
4. **Ordering inputs.**  The Algorithm 5 load vectors come from one
   segment sum (``index_add_``) over the stacked demands on the device.

Everything is exact integer arithmetic.  A bucket whose loads would
overflow int32 goes through ``matching._bna_core_batch`` on the same
device (an exactness branch, counted in ``bucket_fallbacks``, not a device
fallback).  The pieces produced here go into the shared BNA cache, so
python- and pipeline-planned calls interoperate.

:func:`decompose_pieces` is the pieces-only entry of the same bucket sweep
for merge_and_fix's fix-up (the BNA of each merged interval with
alpha > 1, ``timeline._decompose``): no RLE, nothing cached (the fix-up's
demands are decomposed uncached, as in the reference), its own counters.
Every bucket is split into launches under a byte budget
(:data:`LAUNCH_BUDGET_BYTES`): a scale-1.0 plan's merges hold tens of
thousands of interval lanes.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..kernels import resolve_device
from ..kernels.bna_decompose import bna_decompose
from ..kernels.bna_decompose import ops as _decompose_ops
from . import backend as _backend
from .bna import expand_pieces, support_restrict
from .matching import _bna_core_batch, bucket_width

__all__ = [
    "prefetch_demands",
    "decompose_pieces",
    "LAUNCH_BUDGET_BYTES",
    "coflow_edges_rel",
    "instance_load_vectors",
    "edge_cache",
    "pipeline_stats",
    "clear_pipeline_caches",
]

_INT32_MAX = int(np.iinfo(np.int32).max)

#: demand key -> (t0, t1, s, r) int64 *relative* edge intervals (start = 0)
edge_cache = _backend.edge_cache

# counters surfaced via backend.cache_stats()["plan"]: bna_decompose kernel
# launches made here (0 on the CPU), buckets decomposed (a bucket split
# under the byte budget counts once a chunk), decomposition batches, and
# int32-overflow buckets sent down the batched path
_counters = {"launches": 0, "buckets": 0, "batches": 0,
             "bucket_fallbacks": 0}
# the same for merge_and_fix's fix-up (decompose_pieces, or bna_many on the
# python plan backend), with its interval lanes; "fixup" in cache_stats
# adds timeline.fixup_stats's scalar_bna
_fixup = {"lanes": 0, "launches": 0, "buckets": 0, "batches": 0,
          "bucket_fallbacks": 0}

#: device bytes one bna_decompose launch may hold: the lanes' demand stack
#: and its work copy (2 w^2 int32 a lane) and their stored step stacks
#: ((nnz + 2k) (w + 1) int32 a lane); a bucket past it is split
LAUNCH_BUDGET_BYTES = 2 << 30

_warned_overflow = False


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def pipeline_stats() -> dict:
    from .timeline import fixup_stats

    return {"edges": edge_cache.stats(), "decompose": dict(_counters),
            "fixup": {**_fixup, **fixup_stats}}


def clear_pipeline_caches() -> None:
    """Drop cached edge intervals and zero the counters."""
    from .timeline import fixup_stats

    edge_cache.clear()
    for counts in (_counters, _fixup, fixup_stats):
        for k in counts:
            counts[k] = 0


# --------------------------------------------------------------------------
# step stacks -> pieces and edge intervals
# --------------------------------------------------------------------------

def _rle_batch(ts: torch.Tensor, pieces: torch.Tensor):
    """Run-length encode a whole bucket's (B, T, w) piece stack at once, on
    the stack's device.

    An edge (s, piece[b, t, s]) is active during step t; boundaries where
    the receiver changes open/close intervals.  Opens and closes alternate
    per (b, s), so pairing the i-th open with the i-th close (both emitted
    in (b, s, boundary) order by nonzero) reconstructs the intervals.
    Returns host int64 (s, r, t0, t1, offsets) with rows of lane b in
    ``[offsets[b], offsets[b+1])``, ordered by (sender, start time)."""
    B, T, w = pieces.shape
    dev = pieces.device
    times = torch.zeros((B, T + 1), dtype=torch.int64, device=dev)
    times[:, 1:] = torch.cumsum(ts, dim=1, dtype=torch.int64)
    Pt = torch.full((B, w, T + 2), -1, dtype=torch.int32, device=dev)
    Pt[:, :, 1:T + 1] = pieces.transpose(1, 2)
    change = Pt[:, :, 1:] != Pt[:, :, :-1]
    bo, so, to = torch.nonzero(change & (Pt[:, :, 1:] != -1), as_tuple=True)
    bc, sc, tc = torch.nonzero(change & (Pt[:, :, :-1] != -1), as_tuple=True)
    r = Pt[bo, so, to + 1]
    t0 = times[bo, to]
    t1 = times[bc, tc]
    offs = torch.zeros(B + 1, dtype=torch.int64, device=dev)
    offs[1:] = torch.cumsum(torch.bincount(bo, minlength=B), dim=0)
    return tuple(x.to(torch.int64).cpu().numpy()
                 for x in (so, r, t0, t1, offs))


def _steps_to_lists(ts: torch.Tensor, pieces: torch.Tensor, ks: list[int]):
    """Per-lane python (duration, match) lists from the step stacks —
    bit-identical to the batched decomposition's recorded pieces (a lane's
    steps are exactly its prefix of positive durations).  Only those
    prefixes are copied to the host, the receivers as int16 (they lie in
    [-1, w), and a bucket's width w is far below 2^15)."""
    T = ts.shape[1]
    n = (ts > 0).sum(dim=1)
    keep = torch.arange(T, device=ts.device)[None, :] < n[:, None]
    t_h = ts[keep].cpu().numpy().astype(np.int64)
    p_h = pieces[keep].to(torch.int16).cpu().numpy()
    if not bool((t_h > 0).all()):
        raise AssertionError("step stack not a prefix (bug)")
    offs = np.concatenate([[0], np.cumsum(n.cpu().numpy())])
    out = []
    for i, k in enumerate(ks):
        a, b = int(offs[i]), int(offs[i + 1])
        rows = p_h[a:b, :k].astype(np.int64)
        out.append(list(zip(t_h[a:b].tolist(), rows)))
    return out


class _BucketOverflow(Exception):
    """Bucket loads exceed int32 — decompose it on the batched path."""


def _decompose_bucket_device(subs: list[np.ndarray], w: int,
                             device: torch.device, counters: dict,
                             rle: bool = True):
    """Decompose one width bucket through ``bna_decompose`` on `device`;
    returns per matrix ``(pieces_restricted, (t0, t1, s, r) restricted
    rel-edges)``, or the pieces alone when ``rle`` is False."""
    B = len(subs)
    nnz = [int((s > 0).sum()) for s in subs]
    T_cap = _pow2(max(nnz) + 6 * w + 8)
    d = np.zeros((B, w, w), np.int32)
    ks = np.zeros(B, np.int32)
    for i, s in enumerate(subs):
        if max(int(s.sum(axis=1).max()), int(s.sum(axis=0).max())) \
                >= _INT32_MAX:
            raise _BucketOverflow
        k = s.shape[0]
        d[i, :k, :k] = s
        ks[i] = k
    # each step zeroes a real matched edge or makes a port tight, so a
    # lane takes at most nnz + 2k steps: store that many
    t_store = max(z + 2 * s.shape[0] for z, s in zip(nnz, subs))
    before = _decompose_ops.bna_decompose.launches
    ts, pieces, D_end, _ = bna_decompose(
        torch.from_numpy(d).to(device), torch.from_numpy(ks).to(device),
        T_cap, t_store=t_store)
    counters["launches"] += _decompose_ops.bna_decompose.launches - before
    counters["buckets"] += 1
    if bool((D_end != 0).any()):
        raise AssertionError("bna_decompose failed to terminate (bug)")
    plists = _steps_to_lists(ts, pieces, [s.shape[0] for s in subs])
    if not rle:
        return plists
    so, r, t0, t1, offs = _rle_batch(ts, pieces)
    rels = [(t0[offs[i]:offs[i + 1]], t1[offs[i]:offs[i + 1]],
             so[offs[i]:offs[i + 1]], r[offs[i]:offs[i + 1]])
            for i in range(B)]
    return list(zip(plists, rels))


def _decompose_bucket_py(subs: list[np.ndarray], w: int,
                         device: torch.device, counters: dict,
                         rle: bool = True):
    """int32-overflow branch: the batched decomposition
    (``matching._bna_core_batch``) on the same device, then the python
    RLE (unless ``rle`` is False)."""
    from .timeline import bna_pieces_to_edge_intervals

    global _warned_overflow
    if not _warned_overflow:
        _warned_overflow = True
        warnings.warn(
            "planning pipeline: bucket loads exceed int32; decomposing "
            "through the batched path", RuntimeWarning)
    counters["bucket_fallbacks"] += 1
    if not rle:
        return _bna_core_batch(subs, w, device)
    out = []
    for plist in _bna_core_batch(subs, w, device):
        ei = bna_pieces_to_edge_intervals(plist, 0)
        out.append((plist, (ei.t0, ei.t1, ei.s, ei.r)))
    return out


def _restrict_and_bucket(demands) -> tuple[list, dict[int, list]]:
    """Support-restrict every demand (``bna.support_restrict``) and bucket
    the restricted matrices by padded width: ``(restricted, buckets)``,
    where ``restricted[i]`` is ``(sub, rows_p, cols_p, m_full)`` (``sub``
    None for an all-zero demand) and ``buckets[w]`` lists the indices of
    width w, in input order."""
    restricted: list = []
    buckets: dict[int, list] = {}
    for i, dem in enumerate(demands):
        d_full = np.asarray(dem, dtype=np.int64)
        sub, rows_p, cols_p = support_restrict(d_full)
        restricted.append((sub, rows_p, cols_p, d_full.shape[0]))
        if sub is not None:
            buckets.setdefault(bucket_width(sub.shape[0]), []).append(i)
    return restricted, buckets


def _chunks(subs: list[np.ndarray], w: int, budget: int) -> list[slice]:
    """Split one bucket's lanes, in order, into launches whose device
    bytes (demand stack, work copy and stored steps, as
    :data:`LAUNCH_BUDGET_BYTES` counts them) stay within `budget`; a lane
    alone over it is a launch of its own."""
    out: list[slice] = []
    lo, t_max = 0, 0
    for i, s in enumerate(subs):
        t = int((s > 0).sum()) + 2 * s.shape[0]
        t_new = max(t_max, t)
        if i > lo and 4 * (i + 1 - lo) * (2 * w * w + t_new * (w + 1)) \
                > budget:
            out.append(slice(lo, i))
            lo, t_new = i, t
        t_max = t_new
    if lo < len(subs):
        out.append(slice(lo, len(subs)))
    return out


def _run_buckets(restricted: list, buckets: dict[int, list],
                 dev: torch.device, counters: dict, rle: bool) -> list:
    """Decompose every bucket, chunk by chunk under
    :data:`LAUNCH_BUDGET_BYTES`, on `dev`:
    ``bna_decompose`` per chunk, or the batched path for a chunk whose
    loads pass int32.  Returns per restricted item its result (pieces,
    with rel-edges when ``rle``), None for an all-zero demand."""
    out: list = [None] * len(restricted)
    for w in sorted(buckets):
        idx = buckets[w]
        subs = [restricted[i][0] for i in idx]
        for sl in _chunks(subs, w, LAUNCH_BUDGET_BYTES):
            part = subs[sl]
            try:
                res = _decompose_bucket_device(part, w, dev, counters, rle)
            except _BucketOverflow:
                res = _decompose_bucket_py(part, w, dev, counters, rle)
            for i, r in zip(idx[sl], res):
                out[i] = r
    return out


def _plan_decompositions(demands: list[np.ndarray],
                         device: "str | torch.device" = "cuda"):
    """(pieces, rel_edges) per demand: pieces are full-m (duration, match)
    lists bit-identical to ``bna.bna``; rel_edges are (t0, t1, s, r) int64
    edge intervals of the coflow's isolated schedule anchored at 0."""
    dev = resolve_device(device)
    _counters["batches"] += 1
    restricted, buckets = _restrict_and_bucket(demands)
    res = _run_buckets(restricted, buckets, dev, _counters, True)
    out_p: list = []
    out_e: list = []
    for (sub, rows_p, cols_p, m_full), r in zip(restricted, res):
        if sub is None:
            z = np.zeros(0, np.int64)
            out_p.append([])
            out_e.append((z, z.copy(), z.copy(), z.copy()))
            continue
        plist, rel = r
        if rows_p is None:
            out_p.append(plist)
            out_e.append(rel)
        else:
            out_p.append(expand_pieces(plist, rows_p, cols_p, m_full))
            t0, t1, ss, rr = rel
            out_e.append((t0, t1, rows_p[ss], cols_p[rr]))
    return out_p, out_e


def decompose_pieces(subs: list[np.ndarray],
                     device: "str | torch.device" = "cuda") -> list[list]:
    """BNA pieces of each support-restricted k x k matrix in `subs` (its
    loaded rows and columns first, as ``bna.support_restrict`` leaves
    them), each bit-identical to ``bna.bna`` of the matrix: one
    ``bna_decompose`` launch per width bucket and chunk under
    :data:`LAUNCH_BUDGET_BYTES` on `device`, its plain version on the CPU.
    The fix-up's entry: no RLE and no cache; counted in
    ``cache_stats()["plan"]["fixup"]``."""
    dev = resolve_device(device)
    restricted, buckets = _restrict_and_bucket(subs)
    if any(sub is None or rows_p is not None
           for sub, rows_p, _, _ in restricted):
        raise ValueError("decompose_pieces takes support-restricted, "
                         "nonzero matrices")
    return _run_buckets(restricted, buckets, dev, _fixup, False)


# --------------------------------------------------------------------------
# cache-facing entry points
# --------------------------------------------------------------------------

def prefetch_demands(demands, device: "str | torch.device" = "cuda") -> None:
    """Warm BOTH the shared BNA cache and the edge cache for every demand in
    one width-bucketed sweep on `device` — the pipeline's analogue of
    ``backend.prefetch_bna``, with the same thrash guard."""
    bna_cache = _backend.bna_cache
    if bna_cache.maxsize <= 0:
        return
    ds = [np.asarray(d) for d in demands]
    if not ds:
        return
    edge_cache.maxsize = bna_cache.maxsize
    keys = [_backend._bna_key(d) for d in ds]
    if len(set(keys)) > bna_cache.maxsize:
        return
    miss_keys: list = []
    miss_demands: list = []
    seen: set = set()
    for key, dem in zip(keys, ds):
        if key in seen:
            continue
        seen.add(key)
        e_hit, _ = edge_cache.lookup(key)
        p_hit, _ = bna_cache.lookup(key)
        if e_hit and p_hit:
            continue
        miss_keys.append(key)
        miss_demands.append(dem)
    if not miss_demands:
        return
    pieces_list, edges_list = _plan_decompositions(miss_demands, device)
    for key, p, e in zip(miss_keys, pieces_list, edges_list):
        bna_cache.store(key, p)
        edge_cache.store(key, e)


def coflow_edges_rel(demand: np.ndarray,
                     device: "str | torch.device" = "cuda"):
    """(t0, t1, s, r) relative edge intervals of `demand`'s BNA schedule
    (start = 0), memoized on the BNA key; a miss decomposes on `device`.
    The arrays are shared across callers and must be treated as read-only
    (like cached pieces)."""
    dem = np.asarray(demand)
    key = _backend._bna_key(dem)
    edge_cache.maxsize = _backend.bna_cache.maxsize
    found, rel = edge_cache.lookup(key)
    if found:
        return rel
    pieces_list, edges_list = _plan_decompositions(
        [np.asarray(dem, np.int64)], device)
    rel = edges_list[0]
    edge_cache.store(key, rel)
    if not _backend.bna_cache.lookup(key)[0]:
        _backend.bna_cache.store(key, pieces_list[0])
    return rel


# --------------------------------------------------------------------------
# ordering inputs (Algorithm 5 load vectors / grouping prefix sizes)
# --------------------------------------------------------------------------

def instance_load_vectors(instance, device: "str | torch.device" = "cuda"
                          ) -> np.ndarray | None:
    """(n, 2m) float64 per-job aggregate load vectors: a segment sum over
    the stacked demands on `device`, the mirror of
    ``ordering.job_load_vectors`` (integer sums, so values are
    bit-identical).  None when the instance's total demand would overflow
    int32 (callers then take the host path), as in the reference."""
    jobs = instance.jobs
    m = instance.m
    n = len(jobs)
    if n == 0 or m == 0:
        return np.zeros((n, 2 * m), dtype=np.float64)
    if instance.total_demand() >= _INT32_MAX:
        return None
    dems = [c.demand for j in jobs for c in j.coflows]
    if not dems:
        return np.zeros((n, 2 * m), dtype=np.float64)
    dev = resolve_device(device)
    dstack = torch.from_numpy(np.stack(dems).astype(np.int32)).to(dev)
    seg = torch.from_numpy(np.repeat(
        np.arange(n), [len(j.coflows) for j in jobs])).to(dev)
    loads = torch.zeros((n, 2 * m), dtype=torch.int64, device=dev)
    loads[:, :m].index_add_(0, seg, dstack.sum(dim=2))
    loads[:, m:].index_add_(0, seg, dstack.sum(dim=1))
    return loads.cpu().numpy().astype(np.float64)

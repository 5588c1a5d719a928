"""Batched matching — multi-coflow BNA (Algorithm 1 across a whole batch),
the port of ``repro.core.matching``.

:func:`bna_many` decomposes many demand matrices at once:

1. **Support-restrict** each demand exactly as the scalar path does
   (`bna.support_restrict`), then **bucket** the k x k matrices by padded
   width w (next power of two).  Padding ports carry zero load, so the
   padded stack decomposes to exactly the same pieces as the matrices
   alone.
2. Run the **filled-matrix decomposition in lock-step** across the bucket.
   The demand stack, row and col loads, D and the matching live on the
   device for the whole bucket (int32 while every effective size is below
   2^31 - 1, int64 past it, as the reference's numpy step), and every step is one ``bna_step`` call
   (the CUDA kernel on a card, its plain version on the CPU).  Per step
   only the packed ``[t | D' | piece | invalid]`` rows come back to the
   host.  The augmenting-path repair stays on the host, as in the
   reference: only matrices whose matching was invalidated copy their
   d/row/col down, and their repaired matching row goes back up.
   Matrices whose D hits zero leave the active set; the batch is compacted
   whenever more than half of it has drained.
3. Map the collected pieces back through the support remap
   (`bna.expand_pieces`).

The matrices are independent, so interleaving their iterations cannot
change any matrix's own step sequence: pieces are bit-identical to the
scalar ``bna`` and to the reference's ``bna_many``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..kernels import resolve_device
from ..kernels.bna_step import bna_step, stage_state
from .bna import (_NO_MATCH, expand_pieces, support_restrict,
                  verify_bna_schedule)

__all__ = ["bna_many", "bucket_width", "stats"]

# steps: batched bna_step calls; repairs: per-matrix host repairs;
# step_s: host seconds in the steps, each up to its packed rows on the host
# (kernel and device->host copy); repair_s: host seconds in the repairs,
# copies included.  Read by backend.cache_stats(), reset by
# backend.clear_caches().
stats = {"steps": 0, "repairs": 0, "step_s": 0.0, "repair_s": 0.0}


def bucket_width(k: int) -> int:
    """Padded batch width for a k x k support-restricted demand: the next
    power of two, so mixed-width instances land in O(log m) buckets."""
    return 1 << max(k - 1, 0).bit_length()


def bna_many(
    demands: list[np.ndarray],
    validate: bool = False,
    device: "str | torch.device" = "cuda",
) -> list[list[tuple[int, np.ndarray]]]:
    """Decompose every demand in `demands`; element i is bit-identical to
    ``bna(demands[i])``.  The batched step runs on `device`."""
    dev = resolve_device(device)
    out: list[list[tuple[int, np.ndarray]] | None] = [None] * len(demands)
    buckets: dict[int, list[tuple[int, np.ndarray, np.ndarray | None,
                                  np.ndarray | None, int]]] = {}
    for i, dem in enumerate(demands):
        d_full = np.asarray(dem, dtype=np.int64)
        sub, rows_p, cols_p = support_restrict(d_full)
        if sub is None:
            out[i] = []
            continue
        w = bucket_width(sub.shape[0])
        buckets.setdefault(w, []).append(
            (i, sub, rows_p, cols_p, d_full.shape[0]))
    for w in sorted(buckets):
        items = buckets[w]
        pieces_lists = _bna_core_batch([it[1] for it in items], w, dev)
        for (i, _sub, rows_p, cols_p, m_full), pieces in zip(items, pieces_lists):
            out[i] = pieces if rows_p is None else \
                expand_pieces(pieces, rows_p, cols_p, m_full)
            if validate:
                verify_bna_schedule(np.asarray(demands[i], dtype=np.int64),
                                    out[i])
    return out  # type: ignore[return-value]


# --------------------------------------------------------------------------
# host repair (identical to the reference's)
# --------------------------------------------------------------------------

def _augment_py(start: int, k: int, dlist: list, rowlist: list,
                collist: list, Dv: int, msr: list, mrs: list) -> bool:
    """`bna._augment` on Python-native state: the identical search —
    frontiers built in increasing receiver order when a sender is first
    reached, consumed with visited-skipping, alternating-path augmentation
    on the first free receiver — over plain lists, so the matchings it
    produces are identical."""
    visited = [False] * k
    parent_r: dict[int, int] = {}
    stack = [start]
    frontier: dict[int, list[int]] = {}
    pos: dict[int, int] = {}
    while stack:
        s = stack[-1]
        f = frontier.get(s)
        if f is None:
            ds = dlist[s]
            if rowlist[s] < Dv:
                f = [r for r in range(k)
                     if not visited[r] and (ds[r] > 0 or collist[r] < Dv)]
            else:
                f = [r for r in range(k) if not visited[r] and ds[r] > 0]
            frontier[s] = f
            pos[s] = 0
        found = False
        p = pos[s]
        while p < len(f):
            r = f[p]
            p += 1
            if visited[r]:
                continue
            visited[r] = True
            parent_r[r] = s
            nxt = mrs[r]
            if nxt == _NO_MATCH:
                pos[s] = p
                while True:   # augment along the alternating path to start
                    ps = parent_r[r]
                    prev_r = msr[ps]
                    msr[ps] = r
                    mrs[r] = ps
                    if ps == start:
                        return True
                    r = prev_r
            else:
                pos[s] = p
                stack.append(nxt)
                found = True
                break
        if not found:
            pos[s] = p
            stack.pop()
            frontier.pop(s, None)
    return False


def _repair_one(d2: np.ndarray, row1: np.ndarray, col1: np.ndarray, Dv: int,
                msr: np.ndarray, mrs: np.ndarray, k: int,
                bad: np.ndarray) -> None:
    """Scalar repair() for one matrix of the batch: clear the invalidated
    matched edges (`bad`, ascending sender order), then re-augment
    unmatched senders in increasing order.  With nothing to clear from an
    all-unmatched state it builds the initial perfect matching."""
    dlist = d2[:k, :k].tolist()
    rowlist = row1[:k].tolist()
    collist = col1[:k].tolist()
    msr_l = msr[:k].tolist()
    mrs_l = mrs[:k].tolist()
    for s in np.flatnonzero(bad):
        r = msr_l[s]
        msr_l[s] = _NO_MATCH
        mrs_l[r] = _NO_MATCH
    for s in range(k):
        if msr_l[s] == _NO_MATCH:
            if not _augment_py(s, k, dlist, rowlist, collist, Dv,
                               msr_l, mrs_l):
                raise AssertionError(
                    "BNA invariant violated: no perfect matching")
    msr[:k] = msr_l
    mrs[:k] = mrs_l


# --------------------------------------------------------------------------
# batched core
# --------------------------------------------------------------------------

def _bna_core_batch(
    subs: list[np.ndarray], w: int, device: torch.device,
) -> list[list[tuple[int, np.ndarray]]]:
    """Decompose a bucket of support-restricted matrices (each k x k with
    bucket_width(k) == w) in lock-step on `device`.  Returns per-matrix
    pieces, each bit-identical to ``_bna_core`` on that matrix alone."""
    B = len(subs)
    ks_full = np.array([s.shape[0] for s in subs], dtype=np.int64)
    ks = ks_full.copy()
    d = np.zeros((B, w, w), dtype=np.int64)
    for i, s in enumerate(subs):
        k = s.shape[0]
        d[i, :k, :k] = s
    row = d.sum(axis=2)
    col = d.sum(axis=1)
    D = np.maximum(row.max(axis=1), col.max(axis=1))
    match_sr = np.full((B, w), _NO_MATCH, dtype=np.int64)
    match_rs = np.full((B, w), _NO_MATCH, dtype=np.int64)
    for i in range(B):
        _repair_one(d[i], row[i], col[i], int(D[i]), match_sr[i],
                    match_rs[i], int(ks[i]), np.zeros(int(ks[i]), dtype=bool))
    # scalar guard: nnz + 2m + 4 iterations, slack 4m — take the bucket max
    guard = int((d > 0).sum(axis=(1, 2)).max(initial=0)) + 6 * w + 8
    d_t, row_t, col_t, D_t, match_t = stage_state(d, row, col, D, match_sr,
                                                  device)
    del d, row, col

    pieces_out: list[list[tuple[int, np.ndarray]]] = [[] for _ in range(B)]
    ids = np.arange(B, dtype=np.int64)
    steps: list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []
    it = 0
    while True:
        alive = D > 0
        if not alive.any():
            break
        it += 1
        if it > guard:
            raise AssertionError("batched BNA failed to terminate (bug)")
        t_step = time.perf_counter()
        packed = bna_step(d_t, row_t, col_t, D_t, match_t).cpu().numpy()
        t_repair = time.perf_counter()
        stats["step_s"] += t_repair - t_step
        stats["steps"] += 1
        t = packed[:, 0].astype(np.int64)
        D = packed[:, 1].astype(np.int64)
        piece = packed[:, 2:2 + w].astype(np.int64)
        invalid = packed[:, 2 + w:].astype(bool)
        assert bool((t[alive] > 0).all()), "zero-length BNA step (bug)"
        steps.append((ids, t, piece, alive))

        finished = np.flatnonzero(alive & (D == 0))
        match_sr[finished] = _NO_MATCH   # neutralize: no repair, t=0
        match_rs[finished] = _NO_MATCH
        bad = np.flatnonzero(invalid.any(axis=1))
        if bad.size:
            sel = torch.from_numpy(bad).to(device)
            d_h = d_t.index_select(0, sel).cpu().numpy()
            row_h = row_t.index_select(0, sel).cpu().numpy()
            col_h = col_t.index_select(0, sel).cpu().numpy()
            for j, i in enumerate(bad):
                _repair_one(d_h[j], row_h[j], col_h[j], int(D[i]),
                            match_sr[i], match_rs[i], int(ks[i]), invalid[i])
            stats["repairs"] += int(bad.size)
        changed = np.concatenate([finished, bad])
        if changed.size:
            sel = torch.from_numpy(changed).to(device)
            match_t.index_copy_(0, sel, torch.from_numpy(
                match_sr[changed]).to(device=device, dtype=match_t.dtype))
        stats["repair_s"] += time.perf_counter() - t_repair

        live = D > 0
        n_live = int(live.sum())
        if n_live and n_live * 2 < D.size:
            # compact the batch (fresh arrays — recorded `ids` stay valid)
            keep = np.flatnonzero(live)
            sel = torch.from_numpy(keep).to(device)
            d_t, row_t, col_t, D_t, match_t = (
                a.index_select(0, sel).contiguous()
                for a in (d_t, row_t, col_t, D_t, match_t))
            D = D[keep]
            match_sr = match_sr[keep]
            match_rs = match_rs[keep]
            ks = ks[keep]
            ids = ids[keep]

    for ids_a, t_a, piece_a, alive_a in steps:
        for j in np.flatnonzero(alive_a):
            i = int(ids_a[j])
            # slice the padded piece row back to the matrix's own width so
            # pieces are bit-identical to the scalar _bna_core output
            pieces_out[i].append(
                (int(t_a[j]), piece_a[j, : int(ks_full[i])].copy()))
    return pieces_out

"""BNA — Birkhoff–von-Neumann Algorithm (paper Algorithm 1).

Schedules a single coflow (m x m integer demand matrix) optimally: the
returned preemptive schedule finishes in exactly D slots, D = effective size
(Definition 1), which is a lower bound due to unit port capacities.

Implementation notes
--------------------
Algorithm 1 needs, each iteration, a matching "such that all tight nodes are
involved" (line 4). We realize this with the classical filled-matrix
argument (Lawler & Labetoulle 1978): consider the bipartite graph with an
edge (s, r) iff

    d[s, r] > 0                          (a *real* edge), or
    d_s < D and d_r < D                  (a *slack* edge)

A perfect matching always exists in this graph (pad D - d_s / D - d_r slack
to make the matrix doubly stochastic after dividing by D; Birkhoff gives a
perfect matching on its support). Tight nodes admit no slack edges, so any
perfect matching covers every tight node through a real edge. Slack-matched
pairs simply idle; only real matched edges transmit. The step length

    t = min( min_{(s,r) in M, d_sr>0} d_sr,  min_{i not real-matched} D - d_i )

is the faithful reading of line 5 under the filled-matrix construction: a
port matched through a slack edge does not transmit, so it constrains t the
same way an unmatched port does. Each step either zeroes a real matched edge
or makes a port tight, so there are at most nnz + 2m iterations.

The perfect matching is maintained incrementally across iterations (repair
via augmenting paths only for ports whose matched edge became invalid),
keeping the whole decomposition near O((nnz + m) * m) vector ops.

This module is the *scalar reference*: one coflow at a time, the code the
correctness argument above reads against.  The batched subsystem
(``core/matching.py``) decomposes many coflows at once — same pieces,
bit-identical (it shares :func:`support_restrict` / :func:`expand_pieces`
and the `_augment` repair below) — and is what the planning path
actually runs; see ``core/backend.py`` (``bna_pieces``,
``bna_pieces_many``).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "bna",
    "schedule_total_time",
    "verify_bna_schedule",
    "support_restrict",
    "expand_pieces",
]

_NO_MATCH = -1


def _augment(start: int, adj_fn, match_sr: np.ndarray, match_rs: np.ndarray, m: int) -> bool:
    """One augmenting-path search (Kuhn) from unmatched sender `start`.

    adj_fn(s) -> boolean (m,) array of admissible receivers for sender s.
    Iterative DFS; numpy row ops keep the inner loop vectorized.
    """
    visited = np.zeros(m, dtype=bool)
    # stack of (sender, candidate receivers iterator state)
    parent_r: dict[int, int] = {}  # receiver -> sender that reached it
    stack = [start]
    frontier_of: dict[int, np.ndarray] = {}
    while stack:
        s = stack[-1]
        if s not in frontier_of:
            frontier_of[s] = np.flatnonzero(adj_fn(s) & ~visited)
        found = False
        while frontier_of[s].size:
            r = int(frontier_of[s][0])
            frontier_of[s] = frontier_of[s][1:]
            if visited[r]:
                continue
            visited[r] = True
            parent_r[r] = s
            nxt = int(match_rs[r])
            if nxt == _NO_MATCH:
                # augment along alternating path ending at r
                while True:
                    ps = parent_r[r]
                    prev_r = int(match_sr[ps])
                    match_sr[ps] = r
                    match_rs[r] = ps
                    if ps == start:
                        return True
                    r = prev_r
            else:
                stack.append(nxt)
                found = True
                break
        if not found:
            stack.pop()
            frontier_of.pop(s, None)
    return False


def support_restrict(
    demand: np.ndarray,
) -> tuple[np.ndarray | None, np.ndarray | None, np.ndarray | None]:
    """Validate `demand` and restrict it to its SUPPORT ports.

    Returns ``(sub, rows_p, cols_p)``: ``sub`` is the k x k int64 matrix over
    the loaded ports (k = max(#loaded rows, #loaded cols); loaded rows/cols
    first, padded with arbitrary idle ports up to square), ``rows_p`` /
    ``cols_p`` map its axes back to the full port ids — or ``None`` when no
    restriction applies (k == m).  ``sub is None`` means the demand is all
    zero.  Zero-load ports are never tight and never bind the step length,
    so they can idle throughout — this makes the decomposition cost scale
    with the coflow's width, not the switch size.
    """
    d_full = np.asarray(demand, dtype=np.int64)
    if d_full.ndim != 2 or d_full.shape[0] != d_full.shape[1]:
        raise ValueError("demand must be square")
    if (d_full < 0).any():
        raise ValueError("demand must be non-negative")
    m_full = d_full.shape[0]
    rows = np.flatnonzero(d_full.sum(axis=1) > 0)
    cols = np.flatnonzero(d_full.sum(axis=0) > 0)
    k = max(rows.size, cols.size)
    if k == 0:
        return None, None, None
    if k < m_full:
        rows_p = np.concatenate([rows, np.setdiff1d(np.arange(m_full), rows)[: k - rows.size]])
        cols_p = np.concatenate([cols, np.setdiff1d(np.arange(m_full), cols)[: k - cols.size]])
        return d_full[np.ix_(rows_p, cols_p)], rows_p, cols_p
    return d_full, None, None


def expand_pieces(
    pieces: list[tuple[int, np.ndarray]],
    rows_p: np.ndarray, cols_p: np.ndarray, m_full: int,
) -> list[tuple[int, np.ndarray]]:
    """Map support-restricted (duration, matching) pieces back to full
    port ids (inverse of :func:`support_restrict`'s axis remap)."""
    out: list[tuple[int, np.ndarray]] = []
    for t, match in pieces:
        full = np.full(m_full, _NO_MATCH, dtype=np.int64)
        ss = np.flatnonzero(match != _NO_MATCH)
        full[rows_p[ss]] = cols_p[match[ss]]
        out.append((t, full))
    return out


def bna(demand: np.ndarray, validate: bool = False) -> list[tuple[int, np.ndarray]]:
    """Decompose `demand` into a list of (duration, matching) pieces.

    matching: int array (m,), matching[s] = r when (s, r) transmits for the
    whole piece, -1 when sender s idles. Total time == effective size D.

    The matching problem is restricted to the demand's SUPPORT ports via
    :func:`support_restrict`.
    """
    d_full = np.asarray(demand, dtype=np.int64)
    sub, rows_p, cols_p = support_restrict(d_full)
    if sub is None:
        return []
    if rows_p is not None:
        out = expand_pieces(_bna_core(sub), rows_p, cols_p, d_full.shape[0])
        if validate:
            verify_bna_schedule(d_full, out)
        return out
    return _bna_core(sub, validate=validate)


def _bna_core(demand: np.ndarray, validate: bool = False) -> list[tuple[int, np.ndarray]]:
    d = np.array(demand, dtype=np.int64, copy=True)
    m = d.shape[0]
    row = d.sum(axis=1)
    col = d.sum(axis=0)
    D = int(max(row.max(initial=0), col.max(initial=0)))
    if D == 0:
        return []

    match_sr = np.full(m, _NO_MATCH, dtype=np.int64)
    match_rs = np.full(m, _NO_MATCH, dtype=np.int64)

    def adj_fn(s: int) -> np.ndarray:
        # real edges, plus slack edges if sender s is non-tight
        a = d[s] > 0
        if row[s] < D:
            a = a | (col < D)
        return a

    def repair() -> None:
        """Restore a perfect matching after d/row/col/D changed."""
        # invalidate matched edges that left the graph:
        # edge (s, r) is valid iff d[s,r] > 0 or (row[s] < D and col[r] < D)
        ms = np.flatnonzero(match_sr != _NO_MATCH)
        if ms.size:
            rr = match_sr[ms]
            bad = (d[ms, rr] == 0) & ((row[ms] >= D) | (col[rr] >= D))
            for s in ms[bad]:
                r = match_sr[s]
                match_sr[s] = _NO_MATCH
                match_rs[r] = _NO_MATCH
        for s in np.flatnonzero(match_sr == _NO_MATCH):
            if not _augment(int(s), adj_fn, match_sr, match_rs, m):
                raise AssertionError("BNA invariant violated: no perfect matching")

    pieces: list[tuple[int, np.ndarray]] = []
    # initial perfect matching
    repair()
    guard = int(np.count_nonzero(d)) + 2 * m + 4
    it = 0
    while D > 0:
        it += 1
        if it > guard + 4 * m:
            raise AssertionError("BNA failed to terminate (bug)")
        senders = np.arange(m)
        rcv = match_sr
        real = (rcv != _NO_MATCH) & (d[senders, np.maximum(rcv, 0)] > 0)
        # step length (line 5, filled-matrix form)
        t = np.iinfo(np.int64).max
        if real.any():
            t = int(d[senders[real], rcv[real]].min())
        # ports not transmitting constrain t by their slack D - load
        idle_s = ~real
        if idle_s.any():
            t = min(t, int((D - row[idle_s]).min()))
        recv_real = np.zeros(m, dtype=bool)
        recv_real[rcv[real]] = True
        if (~recv_real).any():
            t = min(t, int((D - col[~recv_real]).min()))
        assert t > 0, "zero-length BNA step (bug)"

        piece = np.full(m, _NO_MATCH, dtype=np.int64)
        piece[senders[real]] = rcv[real]
        pieces.append((t, piece))

        # transmit t units on every real matched edge
        sr = senders[real]
        rr = rcv[real]
        d[sr, rr] -= t
        row[sr] -= t
        col[rr] -= t
        D -= t
        if D == 0:
            break
        repair()

    if validate:
        verify_bna_schedule(np.asarray(demand, dtype=np.int64), pieces)
    return pieces


def schedule_total_time(pieces: list[tuple[int, np.ndarray]]) -> int:
    return int(sum(t for t, _ in pieces))


def verify_bna_schedule(demand: np.ndarray, pieces: list[tuple[int, np.ndarray]]) -> None:
    """Check: every piece is a matching; transmissions exactly cover demand;
    total time == effective size."""
    m = demand.shape[0]
    remaining = demand.astype(np.int64).copy()
    for t, piece in pieces:
        assert t > 0
        srcs = np.flatnonzero(piece != _NO_MATCH)
        dsts = piece[srcs]
        assert len(set(dsts.tolist())) == len(dsts), "receivers collide"
        remaining[srcs, dsts] -= t
        assert (remaining[srcs, dsts] >= 0).all(), "over-transmission"
    assert (remaining == 0).all(), "demand not fully served"
    row = demand.sum(axis=1)
    col = demand.sum(axis=0)
    D = int(max(row.max(initial=0), col.max(initial=0)))
    assert schedule_total_time(pieces) == D, "schedule not optimal (!= D)"

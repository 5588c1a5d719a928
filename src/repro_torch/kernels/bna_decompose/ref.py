"""Plain PyTorch version of bna_decompose: a whole width bucket's BNA
decomposition (Algorithm 1 in filled-matrix form), step and repair.

The port's mirror of the reference's compiled bucket program
(``repro/core/pipeline.py::_build_decompose``).  The step is batched over
the lanes as tensor ops (``bna_step_ref``, the same integer formulas); the
augmenting-path repair runs per lane in Python as the reference's
pointer-scan Kuhn search: a sender's admissible receivers are consumed in
increasing order, skipping visited ones, and senders are repaired in
increasing order.  That is the order the CUDA kernel follows too, and the
order that makes the matchings equal the scalar BNA's.

A CPU tensor runs it; ``chip_smoke.py`` holds the CUDA kernel against it on
the card.  Nothing on the card's planning path calls it.  ``tight_bucket``
makes the wide buckets the tests and ``chip_smoke.py`` check it on.
"""
from __future__ import annotations

import numpy as np
import torch

from ..bna_step.ref import NO_MATCH, bna_step_ref, unpack_step


def _augment(start: int, k: int, adm, msr: list, mrs: list) -> tuple:
    """Pointer-scan Kuhn search from unmatched sender `start`; on success
    flips the augmenting walk into msr/mrs (``augment_one`` of the
    reference).  ``adm(s)`` is sender s's admissible-receiver row.  Each
    sender is pushed at most once per search, so its pointer never
    resets.  Returns the search's iterations: (receivers visited, pops)."""
    visited = [False] * k
    ptr = [0] * k
    parent_r = [NO_MATCH] * k
    stack = [start]
    end_r = NO_MATCH
    visits = pops = 0
    while stack:
        s = stack[-1]
        a = adm(s)
        r = ptr[s]
        while r < k and (visited[r] or not a[r]):
            r += 1
        if r == k:
            stack.pop()
            pops += 1
            continue
        visits += 1
        visited[r] = True
        parent_r[r] = s
        ptr[s] = r + 1
        if mrs[r] == NO_MATCH:
            end_r = r
            break
        stack.append(mrs[r])
    r = end_r
    while r != NO_MATCH:
        ps = parent_r[r]
        prev_r = msr[ps]
        msr[ps] = r
        mrs[r] = ps
        r = NO_MATCH if ps == start else prev_r
    return visits, pops


def _repair(d: torch.Tensor, row: torch.Tensor, col: torch.Tensor, Dv: int,
            msr: torch.Tensor, k: int, bad: "list[int]", tally: list) -> None:
    """One lane's repair, in place on its msr row: clear the invalidated
    matched edges, then augment every unmatched sender below k in
    increasing order (from an all-unmatched state this builds the initial
    perfect matching).  Adds the searches, receivers visited and pops to
    ``tally``.  d, row and col do not change during a repair, so a
    sender's admissible receivers (d[s, r] > 0, or row[s] < D and
    col[r] < D) are computed once, when a search first reaches it."""
    msr_l = msr.tolist()
    mrs_l = [NO_MATCH] * len(msr_l)
    for s, r in enumerate(msr_l):
        if r != NO_MATCH:
            mrs_l[r] = s
    for s in bad:
        mrs_l[msr_l[s]] = NO_MATCH
        msr_l[s] = NO_MATCH
    dk = d[:k, :k].cpu()
    slack_row = (row[:k] < Dv).tolist()
    slack_col = (col[:k] < Dv).cpu()
    rows: dict = {}

    def adm(s: int) -> list:
        a = rows.get(s)
        if a is None:
            a = dk[s] > 0
            if slack_row[s]:
                a = a | slack_col
            a = rows[s] = a.tolist()
        return a

    for s in range(k):
        if msr_l[s] == NO_MATCH:
            visits, pops = _augment(s, k, adm, msr_l, mrs_l)
            tally[0] += 1
            tally[1] += visits
            tally[2] += pops
    msr.copy_(torch.tensor(msr_l, dtype=msr.dtype))


def bna_decompose_ref(d: torch.Tensor, ks: torch.Tensor, T_cap: int,
                      counts: "dict | None" = None):
    """(d (B, w, w) int32, ks (B,) int32) -> (ts (B, T) int32, pieces
    (B, T, w) int32, D_final (B,) int32, nsteps (B,) int32).

    Runs lock-step until every lane has drained or T_cap steps; a drained
    lane's steps are no-ops (t = 0, piece all -1).  T is the number of
    steps taken, so ts/pieces are the reference's (B, T_cap) stacks cut
    after the longest lane's last step (the rest of the reference's
    stacks is 0 and -1).  nsteps[b] counts lane b's steps.  `d` is not
    modified.  A ``counts`` dict receives, per lane, the repair's Kuhn
    searches, receivers visited and pops (``"searches"``, ``"visits"``,
    ``"pops"``): a search iteration visits a receiver or pops a sender."""
    B, w, _ = d.shape
    d = d.clone()
    row = d.sum(dim=2, dtype=torch.int32)
    col = d.sum(dim=1, dtype=torch.int32)
    D = torch.maximum(row.amax(dim=1), col.amax(dim=1))
    msr = torch.full((B, w), NO_MATCH, dtype=torch.int32, device=d.device)
    klist = ks.tolist()
    tally = [[0, 0, 0] for _ in range(B)]
    for b in range(B):
        if int(D[b]) > 0:
            _repair(d[b], row[b], col[b], int(D[b]), msr[b], klist[b], [],
                    tally[b])
    ts, pieces = [], []
    while bool((D > 0).any()) and len(ts) < T_cap:
        t, _, piece, invalid = unpack_step(bna_step_ref(d, row, col, D, msr))
        ts.append(t)
        pieces.append(piece)
        for b in torch.nonzero(invalid.any(dim=1)).flatten().tolist():
            bad = torch.nonzero(invalid[b]).flatten().tolist()
            _repair(d[b], row[b], col[b], int(D[b]), msr[b], klist[b], bad,
                    tally[b])
    if ts:
        ts_t = torch.stack(ts, dim=1)
        pieces_t = torch.stack(pieces, dim=1)
    else:
        ts_t = torch.zeros((B, 0), dtype=torch.int32, device=d.device)
        pieces_t = torch.zeros((B, 0, w), dtype=torch.int32, device=d.device)
    nsteps = (ts_t > 0).sum(dim=1, dtype=torch.int32)
    if counts is not None:
        for i, name in enumerate(("searches", "visits", "pops")):
            counts[name] = [x[i] for x in tally]
    return ts_t, pieces_t, D, nsteps


def tight_bucket(rng: np.random.Generator, w: int, lanes) -> tuple:
    """A (len(lanes), w, w) int32 bucket, its ks and a T_cap: lane b sums
    n scaled permutations of size k, for (k, n) = lanes[b].  Every row and
    column of a lane carries the same load, so no port is slack and the
    search sees only the support (a few seconds of the plain version at
    w = 2048, where random sparse lanes keep most ports slack and take it
    minutes).  CPU tensors."""
    d = np.zeros((len(lanes), w, w), np.int32)
    ks = np.zeros(len(lanes), np.int32)
    for b, (k, n) in enumerate(lanes):
        for _ in range(n):
            d[b, np.arange(k), rng.permutation(k)] += int(rng.integers(1, 40))
        ks[b] = k
    nnz = int((d > 0).sum(axis=(1, 2)).max())
    return (torch.from_numpy(d), torch.from_numpy(ks),
            1 << (nnz + 6 * w + 8 - 1).bit_length())

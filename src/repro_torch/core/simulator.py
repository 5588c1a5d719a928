"""Schedule verification — the invariants every algorithm must satisfy.

Used by unit/property tests: (i) per-coflow demand conservation through the
ledger, (ii) Starts-After precedence, (iii) release times, (iv) packet-level
validity of decompositions (matchings, time-disjoint, aggregate-conserving).
"""
from __future__ import annotations

import numpy as np

from .result import CompositeSchedule, Transcript
from .timeline import FinalSchedule
from .types import Instance

__all__ = ["verify_schedule", "verify_decomposition", "verify_transcript"]


def verify_schedule(instance: Instance, sched: CompositeSchedule | FinalSchedule,
                    check_packets: bool | None = None) -> None:
    parts = sched.parts if isinstance(sched, CompositeSchedule) else [sched]
    by_job = {j.jid: j for j in instance.jobs}

    # gather ledger per coflow
    per: dict[tuple[int, int], list] = {}
    for p in parts:
        for e in p.ledger:
            per.setdefault((e.jid, e.cid), []).append(e)

    for j in instance.jobs:
        for c in j.coflows:
            key = (j.jid, c.cid)
            entries = per.get(key, [])
            assert entries, f"coflow {key} never scheduled"
            # (i) conservation: ledger units == demand, edge by edge
            got = np.zeros_like(c.demand, dtype=np.float64)
            for e in entries:
                if e.units.size:
                    np.add.at(got, (e.srcs, e.dsts), e.units)
            assert np.allclose(got, c.demand), f"conservation violated for {key}"
            # (iii) release
            t0 = min(e.e0 for e in entries)
            assert t0 >= j.release - 1e-6, f"coflow {key} starts before release"

    # (ii) precedence through ledger windows
    for j in instance.jobs:
        comp = {}
        start = {}
        for c in j.coflows:
            es = per[(j.jid, c.cid)]
            comp[c.cid] = max(e.e1 for e in es)
            start[c.cid] = min(e.e0 for e in es)
        for a, b in j.edges:
            assert start[b] >= comp[a] - 1e-6, (
                f"precedence violated: job {j.jid}: {a} -> {b} "
                f"(start {start[b]} < parent end {comp[a]})")

    # (iv) packet level, when a decomposition is present
    for p in parts:
        if p.decomposition is not None:
            verify_decomposition(p)
    if check_packets:
        assert any(p.decomposition is not None for p in parts), \
            "packet check requested but no decomposition present"

    # aggregate conservation at packet level across the whole composite
    if all(p.decomposition is not None for p in parts):
        m = instance.m
        total = np.zeros((m, m), dtype=np.int64)
        for j in instance.jobs:
            for c in j.coflows:
                total += c.demand
        moved = np.zeros((m, m), dtype=np.int64)
        for p in parts:
            for piece in p.decomposition:
                np.add.at(moved, (piece.srcs, piece.dsts), piece.dur)
        assert (moved == total).all(), "packet-level aggregate conservation violated"


def verify_transcript(
    instance: Instance, transcript: Transcript,
    check_capacity: bool = False, tol: float = 1e-6,
    makespan: float | None = None,
) -> None:
    """Invariants of an executed-transmission Transcript (any scheduler,
    including backfilled results which have no CompositeSchedule parts):

    (i)   conservation — per coflow, transmitted units == demand edge-wise;
    (ii)  release — no transmission before its job's release;
    (iii) Starts-After precedence — a child's first transmission does not
          precede its last parent's completion;
    (iv)  optionally, uniform-rate port capacity: within every elementary
          interval of the transcript's event partition, the units each port
          sends/receives fit in the interval length.  Only backfilled
          transcripts are exactly capacity-feasible at this level — plain
          schedulers' ledgers are a documented uniform-rate approximation
          (their exact feasibility is packet-level: `verify_schedule` with
          decompose=True);
    (v)   optionally, makespan consistency: pass the executor's reported
          `makespan` and it must cover every coflow completion — including
          zero-demand markers, which transmit nothing but still complete
          (an instance whose jobs are all empty has a positive makespan).
    """
    per: dict[tuple[int, int], list] = {}
    for e in transcript.entries:
        per.setdefault((e.jid, e.cid), []).append(e)

    for j in instance.jobs:
        for c in j.coflows:
            key = (j.jid, c.cid)
            entries = per.get(key, [])
            if (c.demand > 0).any():
                assert entries, f"coflow {key} never transmitted"
            got = np.zeros(c.demand.shape, dtype=np.float64)
            for e in entries:
                if e.units.size:
                    np.add.at(got, (e.srcs, e.dsts), e.units)
            assert np.allclose(got, c.demand, atol=1e-5), \
                f"conservation violated for {key}"
            if entries:
                assert min(e.t0 for e in entries) >= j.release - tol, \
                    f"coflow {key} transmits before release"

    comp = transcript.coflow_completions()
    if makespan is not None and comp:
        worst = max(comp.values())
        assert makespan >= worst - tol, \
            f"makespan {makespan} < last coflow completion {worst}"
    for j in instance.jobs:
        for a, b in j.edges:
            if (j.jid, a) not in comp or (j.jid, b) not in per:
                continue
            # zero-demand children carry only an instantaneous marker entry;
            # its window stands in for the start
            moving = [e for e in per[(j.jid, b)]
                      if e.units.size and e.units.sum() > 0]
            child_start = min(e.t0 for e in (moving or per[(j.jid, b)]))
            assert child_start >= comp[(j.jid, a)] - tol, (
                f"precedence violated: job {j.jid}: {a} -> {b} "
                f"(start {child_start} < parent end {comp[(j.jid, a)]})")

    if check_capacity:
        moving = [e for e in transcript.entries
                  if e.units.size and e.units.sum() > 0 and e.t1 > e.t0]
        events = sorted({t for e in moving for t in (e.t0, e.t1)})
        # sweep the event partition: the entries overlapping [a, b) are
        # those with t0 <= a < t1 (every endpoint is an event), added in
        # transcript order, so each port's sum is the reference's, term for
        # term, without scanning every entry in every interval
        starts: dict = {}
        ends: dict = {}
        for i, e in enumerate(moving):
            starts.setdefault(e.t0, []).append(i)
            ends.setdefault(e.t1, []).append(i)
        active: set = set()
        for a, b in zip(events[:-1], events[1:]):
            active.difference_update(ends.get(a, ()))
            active.update(starts.get(a, ()))
            if not active:
                continue
            over = [moving[i] for i in sorted(active)]
            amount = np.concatenate(
                [e.units * ((min(b, e.t1) - max(a, e.t0)) / (e.t1 - e.t0))
                 for e in over])
            sent = np.zeros(instance.m)
            recv = np.zeros(instance.m)
            np.add.at(sent, np.concatenate([e.srcs for e in over]), amount)
            np.add.at(recv, np.concatenate([e.dsts for e in over]), amount)
            cap = (b - a) * (1 + 1e-9) + tol
            assert sent.max(initial=0) <= cap and recv.max(initial=0) <= cap, \
                f"port capacity exceeded in [{a}, {b})"


def verify_decomposition(p: FinalSchedule) -> None:
    """Every piece a matching; pieces time-disjoint (unit port capacity)."""
    pieces = sorted(p.decomposition, key=lambda x: x.t0)
    prev_end = -np.inf
    for x in pieces:
        assert x.dur > 0
        assert len(np.unique(x.srcs)) == x.srcs.size, "sender used twice in a slot"
        assert len(np.unique(x.dsts)) == x.dsts.size, "receiver used twice in a slot"
        assert x.t0 >= prev_end, "pieces overlap in time"
        prev_end = x.t0 + x.dur

"""Merge-and-fix timeline machinery (paper DMA Steps 3-4, via Lemma 6).

Schedules are piecewise-constant port occupancies. We represent them as
*edge intervals* — an edge (s, r) transmitting at rate 1 over [t0, t1) — the
run-length-encoded form of a sequence of timed matchings (BNA output edges
persist across consecutive pieces, so this is compact: O(nnz + m) intervals
per coflow instead of O(pieces * m)).

merge_and_fix implements exactly Lemma 6: partition time by the set of all
scheduling event times; within each interval the merged demand is constant;
expand interval I of length l_I by alpha_I (the max number of packets any
port must send/receive there) and, when a packet-level schedule is required,
run BNA on (l_I x merged counts). Precedence constraints are preserved
because expansion is order-preserving, and the expanded schedule is feasible
(BNA serves the merged demand within l_I * alpha_I exactly).

Accounting uses a *ledger*: one entry per coflow attributing its flow units
uniformly over its scheduled window; completions and online truncation read
the ledger. The ledger is exact for completion times (a coflow's BNA
finishes exactly at its window end) and a documented uniform-rate
approximation for mid-window truncation.

For exact re-execution, `FinalSchedule.coflow_intervals()` exposes the
expanded schedule as a per-coflow timed-matching decomposition: rate-1 edge
intervals attributed to their (jid, cid), a refinement of the packet-level
matchings (built lazily from the retained merged edges when the schedule
was produced with decompose=False). The packet-level backfill executor
consumes this instead of the ledger approximation.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = [
    "EdgeIntervals",
    "LedgerEntry",
    "UnitSchedule",
    "FinalSchedule",
    "bna_pieces_to_edge_intervals",
    "merge_and_fix",
    "unit_from_coflow_plan",
    "unit_from_coflow_edges",
]


@dataclass
class EdgeIntervals:
    """Struct-of-arrays: edge (s[i], r[i]) active (rate 1) over [t0[i], t1[i]),
    attributed to scheduling unit owner[i] (exact-completion accounting) and
    to its originating coflow (jid[i], cid[i]).  The owner is relative to the
    current merge level (job id inside DMA, coflow id inside DMA-SRT, ...);
    the (jid, cid) channels are global and survive every re-packaging, which
    is what lets a FinalSchedule expose its timed-matching decomposition per
    coflow (the packet-level backfill executor consumes that)."""

    t0: np.ndarray
    t1: np.ndarray
    s: np.ndarray
    r: np.ndarray
    owner: np.ndarray = None
    jid: np.ndarray = None
    cid: np.ndarray = None

    def __post_init__(self):
        if self.owner is None:
            self.owner = np.zeros_like(self.t0)
        if self.jid is None:
            self.jid = np.full_like(self.t0, -1)
        if self.cid is None:
            self.cid = np.full_like(self.t0, -1)

    @staticmethod
    def empty() -> "EdgeIntervals":
        z = np.zeros(0, dtype=np.int64)
        return EdgeIntervals(z.copy(), z.copy(), z.copy(), z.copy(), z.copy(),
                             z.copy(), z.copy())

    @staticmethod
    def concat(parts: list["EdgeIntervals"]) -> "EdgeIntervals":
        parts = [p for p in parts if p.t0.size]
        if not parts:
            return EdgeIntervals.empty()
        return EdgeIntervals(
            np.concatenate([p.t0 for p in parts]),
            np.concatenate([p.t1 for p in parts]),
            np.concatenate([p.s for p in parts]),
            np.concatenate([p.r for p in parts]),
            np.concatenate([p.owner for p in parts]),
            np.concatenate([p.jid for p in parts]),
            np.concatenate([p.cid for p in parts]),
        )

    def shifted(self, dt: int) -> "EdgeIntervals":
        return EdgeIntervals(self.t0 + dt, self.t1 + dt, self.s, self.r,
                             self.owner, self.jid, self.cid)

    def with_owner(self, uid: int) -> "EdgeIntervals":
        return EdgeIntervals(self.t0, self.t1, self.s, self.r,
                             np.full_like(self.t0, uid), self.jid, self.cid)

    @property
    def size(self) -> int:
        return int(self.t0.size)


@dataclass
class LedgerEntry:
    """Attribution: coflow (jid, cid) transmits units[k] on (srcs[k], dsts[k])
    uniformly over [t0, t1). Zero-demand coflows carry an empty entry whose
    window marks their (instantaneous) completion point."""

    jid: int
    cid: int
    t0: int
    t1: int
    srcs: np.ndarray
    dsts: np.ndarray
    units: np.ndarray


@dataclass
class UnitSchedule:
    """One schedulable unit at the current nesting level (an isolated job
    schedule for DMA; a single coflow plan inside DMA-SRT; a whole DMA-SRT
    output inside DMA-RT)."""

    uid: int
    edges: EdgeIntervals
    ledger: list[LedgerEntry]

    def span(self) -> tuple[int, int]:
        lo = [int(self.edges.t0.min())] if self.edges.size else []
        hi = [int(self.edges.t1.max())] if self.edges.size else []
        lo += [e.t0 for e in self.ledger]
        hi += [e.t1 for e in self.ledger]
        return (min(lo, default=0), max(hi, default=0))


def bna_pieces_to_edge_intervals(
    pieces: list[tuple[int, np.ndarray]], start: int, owner: int = 0,
    jid: int = -1, cid: int = -1,
) -> EdgeIntervals:
    """RLE-compress BNA (duration, matching) pieces into edge intervals."""
    t0s: list[int] = []
    t1s: list[int] = []
    ss: list[int] = []
    rs: list[int] = []
    open_edges: dict[tuple[int, int], int] = {}
    t = start
    for dur, match in pieces:
        cur = {(int(s), int(match[s])) for s in np.flatnonzero(match >= 0)}
        for e in list(open_edges):
            if e not in cur:
                t0s.append(open_edges.pop(e))
                t1s.append(t)
                ss.append(e[0])
                rs.append(e[1])
        for e in cur:
            if e not in open_edges:
                open_edges[e] = t
        t += int(dur)
    for e, et0 in open_edges.items():
        t0s.append(et0)
        t1s.append(t)
        ss.append(e[0])
        rs.append(e[1])
    n = len(t0s)
    return EdgeIntervals(
        np.asarray(t0s, dtype=np.int64),
        np.asarray(t1s, dtype=np.int64),
        np.asarray(ss, dtype=np.int64),
        np.asarray(rs, dtype=np.int64),
        np.full(n, owner, dtype=np.int64),
        np.full(n, jid, dtype=np.int64),
        np.full(n, cid, dtype=np.int64),
    )


def _coflow_entry(jid: int, cid: int, demand: np.ndarray,
                  start: int) -> LedgerEntry:
    """Ledger entry for one coflow occupying [start, start + D)."""
    from .types import effective_size

    D = effective_size(demand)
    s_idx, r_idx = np.nonzero(demand)
    return LedgerEntry(
        jid=jid, cid=cid, t0=start, t1=start + D,
        srcs=s_idx.astype(np.int64), dsts=r_idx.astype(np.int64),
        units=demand[s_idx, r_idx].astype(np.float64),
    )


def unit_from_coflow_plan(
    jid: int, cid: int, demand: np.ndarray,
    pieces: list[tuple[int, np.ndarray]], start: int,
) -> UnitSchedule:
    """UnitSchedule for one coflow scheduled by BNA starting at `start`."""
    edges = bna_pieces_to_edge_intervals(pieces, start, owner=cid,
                                         jid=jid, cid=cid)
    return UnitSchedule(uid=jid, edges=edges,
                        ledger=[_coflow_entry(jid, cid, demand, start)])


def unit_from_coflow_edges(
    jid: int, cid: int, demand: np.ndarray,
    rel: tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray], start: int,
) -> UnitSchedule:
    """unit_from_coflow_plan from precomputed start-relative edge intervals
    ``(t0, t1, s, r)`` — the jit planning pipeline's cached representation
    (core/pipeline.py).  Equivalent to RLE-compressing the BNA pieces."""
    t0, t1, s, r = rel
    n = t0.size
    edges = EdgeIntervals(
        t0.astype(np.int64) + int(start),
        t1.astype(np.int64) + int(start),
        s.astype(np.int64),
        r.astype(np.int64),
        np.full(n, cid, dtype=np.int64),
        np.full(n, jid, dtype=np.int64),
        np.full(n, cid, dtype=np.int64),
    )
    return UnitSchedule(uid=jid, edges=edges,
                        ledger=[_coflow_entry(jid, cid, demand, start)])


@dataclass
class MappedEntry:
    jid: int
    cid: int
    e0: float
    e1: float
    srcs: np.ndarray
    dsts: np.ndarray
    units: np.ndarray


@dataclass
class DecompPiece:
    """Packet-level piece in expanded time: matching edges active [t0, t0+dur)."""

    t0: int
    dur: int
    srcs: np.ndarray
    dsts: np.ndarray
    mult: np.ndarray  # per-edge multiplicity of the merged count served here (==1)


@dataclass
class FinalSchedule:
    """Result of merge_and_fix: expanded (feasible) timeline + accounting."""

    m: int
    origin: int
    events: np.ndarray      # (K+1,) original event times (pre-expansion, shifted)
    alphas: np.ndarray      # (K,) max per-port packet count in each interval
    exp: np.ndarray         # (K+1,) expanded times; exp[0] == origin
    ledger: list[MappedEntry]
    decomposition: list[DecompPiece] | None = None
    exact_completion: dict[int, float] | None = None  # per unit uid (packet-exact)
    merged: EdgeIntervals | None = None  # pre-expansion merged edge intervals
    coflow_edges: EdgeIntervals | None = None  # expanded, (jid, cid)-attributed
    _coflow_completion: dict[tuple[int, int], float] | None = None
    # where a lazy fix-up decomposes (coflow_intervals): the device and plan
    # backend of the merge_and_fix that built this schedule; None for a
    # schedule built by hand, whose fix-up runs the scalar host BNA
    device: "torch.device | None" = None
    plan_backend: str | None = None

    # --- time mapping -----------------------------------------------------
    def expand_time(self, t: np.ndarray | float) -> np.ndarray | float:
        """Map original time(s) to expanded time(s); rate-1 outside events."""
        return _expand_time(t, self.events, self.exp, self.origin)

    # --- accounting ---------------------------------------------------------
    def coflow_completions(self) -> dict[tuple[int, int], float]:
        if self._coflow_completion is None:
            comp: dict[tuple[int, int], float] = {}
            for e in self.ledger:
                key = (e.jid, e.cid)
                comp[key] = max(comp.get(key, 0.0), float(e.e1))
            self._coflow_completion = comp
        return self._coflow_completion

    def job_completions(self) -> dict[int, float]:
        """Per-job completions. When a packet-level decomposition was built,
        the PACKET-EXACT time of each job's last transmitted unit is used
        (the conservative ledger window-end otherwise); zero-demand jobs
        fall back to their ledger markers either way."""
        comp: dict[int, float] = {}
        for (jid, _), t in self.coflow_completions().items():
            comp[jid] = max(comp.get(jid, 0.0), t)
        if self.exact_completion:
            # zero-demand coflows have no packets; their ledger markers
            # still gate job completion (e.g. an empty sink coflow)
            zero_mark: dict[int, float] = {}
            for e in self.ledger:
                if e.units.size == 0 or e.units.sum() == 0:
                    zero_mark[e.jid] = max(zero_mark.get(e.jid, 0.0), e.e1)
            for jid, t in self.exact_completion.items():
                if jid in comp:
                    comp[jid] = max(float(t), zero_mark.get(jid, 0.0))
        return comp

    @property
    def makespan(self) -> float:
        """End of the last transmission (trailing idle excluded); packet-
        exact when a decomposition exists, ledger window-end otherwise."""
        if self.exact_completion:
            return float(max(self.exact_completion.values()))
        busy = [e.e1 for e in self.ledger if e.units.size and e.units.sum() > 0]
        if busy:
            return float(max(busy))
        return float(max((e.e1 for e in self.ledger), default=self.origin))

    @property
    def end(self) -> float:
        return float(self.exp[-1]) if self.exp.size else float(self.origin)

    # --- per-coflow timed-matching decomposition ----------------------------
    def coflow_intervals(self) -> EdgeIntervals:
        """The expanded-time edge-interval decomposition attributed per
        coflow: each row is an edge (s, r) transmitting at rate 1 over
        [t0, t1) on behalf of coflow (jid[i], cid[i]).  Rows are a refinement
        of the packet-level matching decomposition, so their union is
        capacity-feasible by construction — this is what the packet-level
        backfill executor re-executes.

        Built lazily from the retained merged edges when the schedule was
        produced with decompose=False; public `decomposition` /
        `exact_completion` accounting is left untouched in that case so plan
        metrics stay order-independent."""
        if self.coflow_edges is None:
            decompose_parts([self])
        return self.coflow_edges

    # --- expansion splicing (session plan repair) ---------------------------
    def shifted_expanded(self, dt: int) -> "FinalSchedule":
        """This schedule translated by ``dt`` on the expanded (absolute)
        clock — the whole-block reuse half of the session's group-aware plan
        repair.  Spread-mode DMA/DMA-SRT layouts are translation invariant
        (``dma(jobs, origin=o)`` equals ``dma(jobs, origin=0)`` shifted by
        ``o``), so a retained G-DM group part whose inputs are untouched can
        be slid to its new chain position instead of being recomputed.

        Pre-expansion state (``events``, ``alphas``, ``merged``) is local to
        the part and unaffected; only the absolute anchors move: ``origin``,
        ``exp``, ledger windows, and — when a packet-level decomposition was
        built — the pieces, exact completions, and per-coflow intervals."""
        dt = int(dt)
        if dt == 0:
            return self
        return FinalSchedule(
            m=self.m,
            origin=self.origin + dt,
            events=self.events,
            alphas=self.alphas,
            exp=self.exp + dt if self.exp.size else self.exp,
            ledger=[MappedEntry(e.jid, e.cid, e.e0 + dt, e.e1 + dt,
                                e.srcs, e.dsts, e.units)
                    for e in self.ledger],
            decomposition=None if self.decomposition is None else
                [DecompPiece(p.t0 + dt, p.dur, p.srcs, p.dsts, p.mult)
                 for p in self.decomposition],
            exact_completion=None if self.exact_completion is None else
                {uid: t + dt for uid, t in self.exact_completion.items()},
            merged=self.merged,
            coflow_edges=None if self.coflow_edges is None else
                self.coflow_edges.shifted(dt),
            device=self.device,
            plan_backend=self.plan_backend,
        )

    def spliced(self, tau: float, keep: set, cid_remap: dict) -> "FinalSchedule":
        """The suffix of this expansion from expanded time ``tau`` on,
        restricted to the coflows in ``keep`` (a set of ``(jid, cid)``) and
        re-labelled via ``cid_remap`` (``(jid, cid) -> new cid``) — the
        retained half of the session's frontier-append plan repair.

        Only expansion-free suffixes can be spliced: every kept coflow must
        lie entirely at or after ``tau`` and every surviving interval must
        have alpha <= 1 (the suffix is its own packet-level schedule, so the
        spliced ledger windows stay exact).  The repair path guarantees both
        by construction; a violation raises ValueError and the caller falls
        back to a full replan.  The suffix keeps this schedule's device and
        plan backend, so its lazy fix-up runs where the plan ran."""
        led: list[MappedEntry] = []
        for e in self.ledger:
            if (e.jid, e.cid) not in keep:
                continue
            if e.e0 < tau - 1e-6:
                raise ValueError("kept coflow starts before the splice point")
            led.append(MappedEntry(e.jid, cid_remap[(e.jid, e.cid)],
                                   e.e0 - tau, e.e1 - tau,
                                   e.srcs, e.dsts, e.units))
        merged = None
        events = np.zeros(0, dtype=np.float64)
        alphas = np.zeros(0, dtype=np.int64)
        exp = np.zeros(0, dtype=np.float64)
        if self.merged is not None and self.merged.size:
            mk = np.array([(int(j), int(c)) in keep
                           for j, c in zip(self.merged.jid, self.merged.cid)])
            if mk.any():
                m_ = self.merged
                # merged edges live in pre-expansion local time; map them
                # through the expansion (exact at event boundaries) so the
                # splice point — which is expanded/absolute — compares
                # correctly for parts with a non-zero origin too (G-DM
                # group parts; om_alg's single part has the identity map)
                et0 = np.round(np.asarray(self.expand_time(m_.t0[mk]),
                                          dtype=np.float64)).astype(np.int64)
                et1 = np.round(np.asarray(self.expand_time(m_.t1[mk]),
                                          dtype=np.float64)).astype(np.int64)
                if int(et0.min()) < tau - 1e-6:
                    raise ValueError("kept merged edge precedes splice point")
                itau = int(round(tau))
                cid_new = np.array(
                    [cid_remap[(int(j), int(c))]
                     for j, c in zip(m_.jid[mk], m_.cid[mk])], dtype=np.int64)
                merged = EdgeIntervals(et0 - itau, et1 - itau,
                                       m_.s[mk], m_.r[mk], m_.owner[mk],
                                       m_.jid[mk], cid_new)
                events, alphas, exp = _expansion_free(merged, self.m,
                                                      "spliced suffix")
        return FinalSchedule(m=self.m, origin=0, events=events, alphas=alphas,
                             exp=exp, ledger=led, merged=merged,
                             device=self.device,
                             plan_backend=self.plan_backend)

    @staticmethod
    def concat_expansion_free(parts: list["FinalSchedule"],
                              m: int) -> "FinalSchedule":
        """Merge already-expanded, expansion-free schedules on a shared
        clock into one (the session's repair path compacts its retained
        suffix with this, so consecutive frontier appends stay O(parts)=2
        instead of accumulating one part per repair).  Raises ValueError if
        the union is not expansion-free — the parts were not actually
        time-disjoint per port.  The parts come from one plan: the result
        keeps the first part's device and plan backend."""
        ledger = [e for p in parts for e in p.ledger]
        ms = [p.merged for p in parts if p.merged is not None and p.merged.size]
        merged = EdgeIntervals.concat(ms) if ms else None
        events = np.zeros(0, dtype=np.float64)
        alphas = np.zeros(0, dtype=np.int64)
        exp = np.zeros(0, dtype=np.float64)
        if merged is not None:
            events, alphas, exp = _expansion_free(merged, m,
                                                  "concatenated parts")
        home = parts[0] if parts else None
        return FinalSchedule(m=m, origin=0, events=events, alphas=alphas,
                             exp=exp, ledger=ledger, merged=merged,
                             device=home.device if home else None,
                             plan_backend=home.plan_backend if home else None)

    # --- nesting ------------------------------------------------------------
    def to_unit(self, uid: int) -> UnitSchedule:
        """Re-package as a UnitSchedule for use at an outer merge level
        (DMA-RT merges whole DMA-SRT schedules).  Edges are the per-coflow
        timed-matching rows, so the (jid, cid) attribution survives the
        outer merge_and_fix."""
        if self.decomposition is None:
            raise ValueError("to_unit requires decompose=True")
        edges = self.coflow_intervals().with_owner(uid)
        ledger = [LedgerEntry(e.jid, e.cid, int(round(e.e0)), int(round(e.e1)),
                              e.srcs, e.dsts, e.units) for e in self.ledger]
        return UnitSchedule(uid=uid, edges=edges, ledger=ledger)


def _expand_time(t, events: np.ndarray, exp: np.ndarray,
                 origin: int) -> np.ndarray | float:
    """Map original time(s) through an expansion (events -> exp); rate 1
    before the first and after the last event."""
    t = np.asarray(t, dtype=np.float64)
    if events.size == 0:
        return t + origin
    lo, hi = events[0], events[-1]
    out = np.interp(np.clip(t, lo, hi), events, exp)
    out = np.where(t < lo, exp[0] - (lo - t), out)
    out = np.where(t > hi, exp[-1] + (t - hi), out)
    return out if out.ndim else float(out)


def _expansion_free(merged: EdgeIntervals, m: int, what: str):
    """(events, alphas, exp) of an already-expanded edge set whose every
    interval must have alpha <= 1 (a spliced or concatenated schedule);
    raises ValueError otherwise.  The alphas come from coflow_merge's plain
    version on the host, as the reference checks with its numpy oracle: a
    cheap self-check, not a step of the plan."""
    from .backend import compute_alphas

    ev = np.unique(np.concatenate([merged.t0, merged.t1]))
    alphas = compute_alphas(ev, merged, m, device="cpu")
    if (alphas > 1).any():
        raise ValueError(f"{what} is not expansion-free")
    events = ev.astype(np.float64)
    return events, alphas, events.copy()


def merge_and_fix(
    units: list[UnitSchedule],
    m: int,
    delays: dict[int, int] | None = None,
    origin: int = 0,
    decompose: bool = False,
    device: "str | torch.device" = "cuda",
    plan_backend: "str | None" = None,
) -> FinalSchedule:
    """DMA Steps 3-4 (Lemma 6): delay, merge, and expand to feasibility.

    delays: per-uid integer delay (Step 2); default 0.
    decompose: also produce the packet-level schedule (BNA per merged
      interval) — needed for verification and for nesting into DMA-RT.
    device: where the alphas are computed and the fix-up BNA runs (kernels
      on a card, their plain versions on the CPU; the same integers either
      way).  The schedule records it, so a later ``coflow_intervals()``
      decomposes there too.
    plan_backend: "pipeline" computes alphas and expanded durations in one
      fused merge_fix call and decomposes the fix-up through bna_decompose;
      "python" runs coflow_merge, then the product on the host, and
      decomposes through bna_many (default: by device, see
      backend.resolve_plan_backend).
    """
    from .backend import (compute_alphas, fused_merge_fix,
                          resolve_plan_backend)

    delays = delays or {}
    shifted: list[EdgeIntervals] = []
    for u in units:
        dt = int(delays.get(u.uid, 0))
        shifted.append(u.edges.shifted(dt) if dt else u.edges)
    edges = EdgeIntervals.concat(shifted)

    if edges.size:
        events = np.unique(np.concatenate([edges.t0, edges.t1]))
    else:
        events = np.zeros(0, dtype=np.int64)

    fused = fused_merge_fix(events, edges, m, plan_backend, device)
    if fused is not None:
        alphas, deltas = fused
        K = alphas.size
        exp = np.concatenate([[0], np.cumsum(deltas)]).astype(np.float64)
    else:
        alphas = compute_alphas(events, edges, m, device=device)
        K = alphas.size
        lens = (events[1:] - events[:-1]) if K else \
            np.zeros(0, dtype=np.int64)
        rates = np.maximum(alphas, 1)
        exp = np.concatenate([[0], np.cumsum(lens * rates)]) \
            .astype(np.float64)
    # anchor: relative time 0 corresponds to `origin`; the idle lead-in up
    # to the first event passes at rate 1 (delays / release waits are real)
    exp += origin + (float(events[0]) if K else 0.0)
    events_f = events.astype(np.float64) if K else np.zeros(0)
    exp_f = exp if K else np.zeros(0)

    # map ledgers through the expansion
    ledger: list[MappedEntry] = []
    for u in units:
        dt = int(delays.get(u.uid, 0))
        for e in u.ledger:
            e0 = float(_expand_time(e.t0 + dt, events_f, exp_f, origin))
            e1 = float(_expand_time(e.t1 + dt, events_f, exp_f, origin))
            ledger.append(MappedEntry(e.jid, e.cid, e0, e1, e.srcs, e.dsts,
                                      e.units))

    dev = torch.device(device)
    plan_backend = resolve_plan_backend(plan_backend, dev)
    decomposition = exact = coflow_edges = None
    if decompose:
        decomposition, exact, coflow_edges = _decompose(
            events, edges, alphas, exp, m, device=dev,
            plan_backend=plan_backend)
    return FinalSchedule(m=m, origin=origin, events=events_f, alphas=alphas,
                         exp=exp_f, ledger=ledger,
                         decomposition=decomposition,
                         exact_completion=exact, merged=edges,
                         coflow_edges=coflow_edges, device=dev,
                         plan_backend=plan_backend)


# --------------------------------------------------------------------------
# packet-level fix-up (Lemma 6's BNA per merged interval)
# --------------------------------------------------------------------------

#: scalar host ``bna`` calls made by the fix-up: only a schedule that records
#: no device (built by hand, not by merge_and_fix) takes that path, so this
#: reads 0 for every plan.  Surfaced in ``cache_stats()["plan"]["fixup"]``.
fixup_stats = {"scalar_bna": 0}


@dataclass
class _Interval:
    """One merged interval of the fix-up walk, recorded by the first pass:
    its expanded start, length and alpha, its active edges and their merged
    counts, and per edge the FIFO queue of contributing units."""

    t_exp: int
    l: int
    a: int
    srcs: np.ndarray
    dsts: np.ndarray
    cnts: np.ndarray
    queues: dict


def _fixup_walk(events: np.ndarray, edges: EdgeIntervals,
                alphas: np.ndarray, exp: np.ndarray) -> list[_Interval]:
    """First pass: walk the intervals in order, maintaining the per-edge
    activation lists, and record every interval that has active edges and
    positive length."""
    K = alphas.size
    si = np.searchsorted(events, edges.t0)
    ei = np.searchsorted(events, edges.t1)
    add_at: list[list[int]] = [[] for _ in range(K + 1)]
    rem_at: list[list[int]] = [[] for _ in range(K + 1)]
    for i in range(edges.size):
        add_at[si[i]].append(i)
        rem_at[ei[i]].append(i)
    # per edge: ordered list of (activation_seq, (owner, jid, cid), mult)
    active: dict[tuple[int, int], list] = {}
    seq = 0
    out: list[_Interval] = []
    for k in range(K):
        for i in rem_at[k]:
            key = (int(edges.s[i]), int(edges.r[i]))
            k3 = (int(edges.owner[i]), int(edges.jid[i]), int(edges.cid[i]))
            lst = active[key]
            for j, ent in enumerate(lst):
                if ent[1] == k3:
                    if ent[2] == 1:
                        lst.pop(j)
                    else:
                        ent[2] -= 1
                    break
            if not lst:
                del active[key]
        for i in add_at[k]:
            key = (int(edges.s[i]), int(edges.r[i]))
            k3 = (int(edges.owner[i]), int(edges.jid[i]), int(edges.cid[i]))
            lst = active.setdefault(key, [])
            for ent in lst:
                if ent[1] == k3:
                    ent[2] += 1
                    break
            else:
                lst.append([seq, k3, 1])
                seq += 1
        if not active:
            continue
        l = int(events[k + 1] - events[k])
        if l == 0:
            continue
        srcs = np.array([s for s, _ in active], dtype=np.int64)
        dsts = np.array([r for _, r in active], dtype=np.int64)
        cnts = np.array([sum(e[2] for e in lst) for lst in active.values()],
                        dtype=np.int64)
        # FIFO queues for this interval: per edge, units in activation order
        queues = {key: [[k3, mult * l] for _, k3, mult in sorted(lst)]
                  for key, lst in active.items()}
        out.append(_Interval(int(round(exp[k])), l, int(alphas[k]), srcs,
                             dsts, cnts, queues))
    return out


def _restricted_demand(iv: _Interval, m: int):
    """``support_restrict`` of the interval's merged demand
    ``dm[srcs, dsts] = cnts * l`` (m x m), built from the active edges
    without the dense matrix: ``(sub, rows_p, cols_p)``, equal to
    ``bna.support_restrict(dm)``."""
    vals = iv.cnts * iv.l
    rows = np.unique(iv.srcs)
    cols = np.unique(iv.dsts)
    k = max(rows.size, cols.size)
    if k < m:
        def padded(ports):   # the loaded ports, then the first idle ones
            idle = np.ones(m, dtype=bool)
            idle[ports] = False
            return np.concatenate(
                [ports, np.flatnonzero(idle)[: k - ports.size]])

        rows_p, cols_p = padded(rows), padded(cols)
        sub = np.zeros((k, k), dtype=np.int64)
        sub[np.searchsorted(rows, iv.srcs), np.searchsorted(cols, iv.dsts)] \
            = vals
        return sub, rows_p, cols_p
    sub = np.zeros((m, m), dtype=np.int64)
    sub[iv.srcs, iv.dsts] = vals
    return sub, None, None


def _interval_pieces(walks: list[list[_Interval]], m: int,
                     device: "torch.device | None",
                     plan_backend: str | None) -> list[list[list]]:
    """Fix-up BNA pieces of every interval with alpha > 1 in `walks` (one
    list of intervals per schedule), as ``(duration, senders, receivers)``
    in full port ids, each bit-identical to the scalar ``bna`` of the
    interval's merged demand.  All lanes of all walks go through ONE
    batched decomposition on `device` (``backend.fixup_pieces``); a
    schedule without a device runs the scalar ``bna`` per interval."""
    from .bna import bna

    lanes = [iv for walk in walks for iv in walk if iv.a > 1]
    if not lanes:
        return [[] for _ in walks]
    if device is None:
        fixup_stats["scalar_bna"] += len(lanes)
        per_lane = []
        for iv in lanes:
            dm = np.zeros((m, m), dtype=np.int64)
            dm[iv.srcs, iv.dsts] = iv.cnts * iv.l
            per_lane.append([(int(t), ss, match[ss]) for t, match in bna(dm)
                             for ss in (np.flatnonzero(match >= 0),)])
    else:
        from .backend import fixup_pieces

        restricted = [_restricted_demand(iv, m) for iv in lanes]
        plists = fixup_pieces([r[0] for r in restricted], plan_backend,
                              device)
        per_lane = []
        for (_, rows_p, cols_p), plist in zip(restricted, plists):
            # loaded ports come first, ascending, in rows_p / cols_p and
            # only loaded ports transmit, so mapping the restricted senders
            # keeps bna's ascending full-id order
            out = []
            for t, match in plist:
                ss = np.flatnonzero(match >= 0)
                rr = match[ss]
                if rows_p is not None:
                    ss, rr = rows_p[ss], cols_p[rr]
                out.append((int(t), ss, rr))
            per_lane.append(out)
    it = iter(per_lane)
    return [[next(it) for iv in walk if iv.a > 1] for walk in walks]


def _fixup_emit(walk: list[_Interval], lane_pieces: list[list]):
    """Second pass: per recorded interval, in order, the packet-level pieces,
    the packet-exact completions and the per-coflow segments, from the
    interval's FIFO queues and (alpha > 1) its fix-up BNA pieces."""
    pieces: list[DecompPiece] = []
    completion: dict[int, float] = {}
    seg_t0: list[int] = []
    seg_t1: list[int] = []
    seg_s: list[int] = []
    seg_r: list[int] = []
    seg_own: list[int] = []
    seg_jid: list[int] = []
    seg_cid: list[int] = []

    def emit_seg(t0: int, t1: int, s: int, r: int, key3) -> None:
        if t1 > t0:
            seg_t0.append(t0)
            seg_t1.append(t1)
            seg_s.append(s)
            seg_r.append(r)
            seg_own.append(key3[0])
            seg_jid.append(key3[1])
            seg_cid.append(key3[2])

    lanes = iter(lane_pieces)
    for iv in walk:
        t_exp, l, queues = iv.t_exp, iv.l, iv.queues
        if iv.a <= 1:
            pieces.append(DecompPiece(t_exp, l, iv.srcs, iv.dsts,
                                      np.ones_like(iv.cnts)))
            end = float(t_exp + l)
            for key, q in queues.items():
                cursor = t_exp
                for k3, amt in q:
                    emit_seg(cursor, cursor + amt, key[0], key[1], k3)
                    cursor += amt
                    completion[k3[0]] = max(completion.get(k3[0], 0.0), end)
            continue
        off = 0
        for dur, ss, rr in next(lanes):
            pieces.append(DecompPiece(t_exp + off, dur, ss, rr,
                                      np.ones(ss.size, dtype=np.int64)))
            piece_end = float(t_exp + off + dur)
            for s_, r_ in zip(ss.tolist(), rr.tolist()):
                key = (s_, r_)
                q = queues.get(key)
                if not q:
                    continue
                served = dur
                used = 0
                while served > 0 and q:
                    k3, rem = q[0]
                    take = min(rem, served)
                    rem -= take
                    served -= take
                    emit_seg(t_exp + off + used, t_exp + off + used + take,
                             key[0], key[1], k3)
                    used += take
                    if rem == 0:
                        q.pop(0)
                    else:
                        q[0][1] = rem
                    completion[k3[0]] = max(completion.get(k3[0], 0.0),
                                            piece_end)
            off += dur
        assert off == l * iv.a, "fix-up BNA length mismatch"
    segs = EdgeIntervals(
        np.asarray(seg_t0, dtype=np.int64),
        np.asarray(seg_t1, dtype=np.int64),
        np.asarray(seg_s, dtype=np.int64),
        np.asarray(seg_r, dtype=np.int64),
        np.asarray(seg_own, dtype=np.int64),
        np.asarray(seg_jid, dtype=np.int64),
        np.asarray(seg_cid, dtype=np.int64),
    )
    return pieces, completion, segs


def _decompose(
    events: np.ndarray, edges: EdgeIntervals, alphas: np.ndarray,
    exp: np.ndarray, m: int, device: "torch.device | None" = None,
    plan_backend: str | None = None,
) -> tuple[list[DecompPiece], dict[int, float], EdgeIntervals]:
    """Packet-level fix-up: per interval, BNA(l_I x merged counts), plus
    PACKET-EXACT per-unit completion times: within each interval, an edge's
    merged units are attributed FIFO to the contributing units (activation
    order), and a unit's completion is the end of the piece that serves its
    last packet — the quantity the paper's simulator measures, much tighter
    than the expanded-window end.

    The same FIFO walk records each served stretch as an expanded-time edge
    interval attributed to its (jid, cid) — the per-coflow timed-matching
    decomposition (FinalSchedule.coflow_intervals).  The segments tile the
    packet-level pieces exactly, so per coflow and edge their total length
    equals the coflow's demand on that edge, and at any instant the active
    segments form a matching.

    Fast path: alpha_I == 1 means the merged active edges already form a
    matching — emitted directly without BNA.  The intervals with
    alpha_I > 1 are decomposed in one batch on `device` through
    `plan_backend` (``bna_decompose`` per width bucket, or ``bna_many``),
    between a walk that records them and a pass that emits in interval
    order; ``device=None`` runs the scalar ``bna`` per interval."""
    walk = _fixup_walk(events, edges, alphas, exp) if edges.size else []
    lane_pieces = _interval_pieces([walk], m, device, plan_backend)[0]
    return _fixup_emit(walk, lane_pieces)


def decompose_parts(parts: list[FinalSchedule]) -> None:
    """Build ``coflow_edges`` for every schedule in `parts` that lacks it,
    with the fix-up intervals of all of them decomposed in one batch per
    (device, plan backend) — equal to calling ``coflow_intervals()`` on
    each.  The public ``decomposition`` / ``exact_completion`` accounting
    is left untouched, as ``coflow_intervals`` leaves it."""
    todo = [p for p in parts if p.coflow_edges is None]
    for p in todo:
        if p.merged is None:
            raise ValueError("coflow_intervals requires the merged edge "
                             "intervals (schedule predates merge_and_fix)")
    groups: dict = {}
    for p in todo:
        groups.setdefault((p.device, p.plan_backend, p.m), []).append(p)
    for (device, plan_backend, m), group in groups.items():
        walks = [_fixup_walk(p.events, p.merged, p.alphas, p.exp)
                 if p.merged.size else [] for p in group]
        lanes = _interval_pieces(walks, m, device, plan_backend)
        for p, walk, lp in zip(group, walks, lanes):
            p.coflow_edges = _fixup_emit(walk, lp)[2]

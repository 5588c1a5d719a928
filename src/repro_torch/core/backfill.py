"""Backfilling (paper §VII): allocate under-utilized port capacity to ready
flows of other jobs. Applied identically to every scheduler (G-DM, G-DM-RT,
O(m)Alg) for a fair comparison, exactly as the paper does.  The port of
``repro.core.backfill``: the sweeps are host numpy in float64, with every
float operation in the reference's order, so completions and twct are
bit-equal to it.  The packet executor's input, the plan's per-coflow
timed-matching decomposition, is built on the plan's device: every part's
fix-up BNA in one batch (``timeline.decompose_parts``).

Two executors re-execute a planned CompositeSchedule under exact port
capacity (``exec=`` selects; packet is the default):

``exec="packet"`` — matching-granular sweep over the plan's *actual*
  merge-and-fix output (``FinalSchedule.coflow_intervals()``: the expanded
  timed-matching decomposition attributed per coflow).  Planned edges form a
  matching inside every elementary interval, so step 1 — executing the plan
  — is capacity-feasible by construction and never gets capped; leftover
  per-port slack in each interval is offered greedily to *eligible* flows
  (job released, all Starts-After parents finished at interval entry),
  earliest-planned-completion coflow first.  Because planned service is
  always delivered in full, executed progress dominates the plan pointwise
  and ``twct(backfill) <= twct(plan)`` holds on every instance — the paper's
  premise that backfilling only ever helps.

``exec="ledger"`` — the historical executor: the same sweep over the plan's
  *ledger* (per-coflow uniform-rate windows).  The ledger is a documented
  uniform-rate approximation, so per-interval placement can locally exceed
  port capacity and must be capped, deferring work past its planned window;
  re-executed completions are therefore NOT pointwise comparable to the
  plan (deep chains at larger m exhibit this).  What IS guaranteed is
  monotonicity in ``fill``: filling only ever adds served units, so
  ``twct(fill=True) <= twct(fill=False)`` (the null-backfill comparator).

Both executors share the completion semantics: a coflow completes when its
remaining demand reaches zero (backfilling can finish it well before its
planned window ends), and a zero-demand coflow completes instantaneously at
``max(release, parents' completion)`` — not at its planned window end —
with a zero-width marker entry in the transcript so replay agrees.
Conservation, precedence, release and per-port capacity are respected
exactly by both.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .result import CompositeSchedule, Transcript, TranscriptEntry, twct
from .timeline import EdgeIntervals, decompose_parts
from .types import Instance, parents_of, topological_order

__all__ = ["backfill", "BackfillResult"]

_EXECUTORS = ("packet", "ledger")


@dataclass
class BackfillResult:
    transcript: Transcript
    coflow_completions: dict[tuple[int, int], float]
    job_completions: dict[int, float]
    makespan: float
    instance: Instance
    executor: str = "packet"

    def twct(self, from_release: bool = False) -> float:
        return twct(self.job_completions, self.instance, from_release)


def backfill(sched: CompositeSchedule, fill: bool = True,
             exec: str = "packet") -> BackfillResult:
    """Re-execute `sched` under exact port capacity, offering leftover
    capacity to eligible flows (fill=True).

    `sched` may be a CompositeSchedule or anything wrapping one behind a
    ``.schedule`` attribute (an engine PlanResult), so a plan can be
    backfilled without replanning.

    exec="packet" (default) re-executes the timed-matching decomposition and
    restores the pointwise guarantee twct(backfill) <= twct(plan);
    exec="ledger" re-executes the uniform-rate ledger (the pre-packet
    behavior, kept as a comparator).  fill=False disables step 2 (filling)
    in either executor: for packet that is an exact replay of the plan, for
    ledger it is the *null-backfill* monotonicity comparator (see module
    docstring for why ledger window-ends are not pointwise comparable)."""
    sched = getattr(sched, "schedule", sched)
    if isinstance(sched, BackfillResult):
        raise ValueError(
            f"already backfilled with exec={sched.executor!r}; a "
            f"BackfillResult cannot be re-executed — backfill the plain "
            f"scheduler's plan instead")
    if exec not in _EXECUTORS:
        raise ValueError(f"unknown backfill executor {exec!r}; "
                         f"choose from {_EXECUTORS}")
    if exec == "packet":
        return _packet_sweep(sched, fill)
    return _ledger_sweep(sched, fill)


# --------------------------------------------------------------------------
# shared machinery
# --------------------------------------------------------------------------

def _job_maps(inst: Instance):
    by_id = {j.jid: j for j in inst.jobs}
    parents = {j.jid: parents_of(j.mu, j.edges) for j in inst.jobs}
    topo = {j.jid: topological_order(j.mu, j.edges) for j in inst.jobs}
    return by_id, parents, topo


def _stamp_zero_demand(inst, parents, topo, is_zero, comp, out) -> None:
    """Zero-demand coflows complete instantaneously at max(release,
    parents' completion) — NOT at their planned window end, which would
    inflate job completion (and TWCT) for jobs whose last coflow is empty.
    A zero-width marker entry is appended so transcript replay agrees."""
    z = np.zeros(0, dtype=np.int64)
    for j in inst.jobs:
        for cid in topo[j.jid]:
            key = (j.jid, cid)
            if key not in is_zero:
                continue
            t = max([comp[(j.jid, q)] for q in parents[j.jid][cid]]
                    + [float(j.release)])
            comp[key] = t
            out.append(TranscriptEntry(j.jid, cid, t, t, z, z,
                                       np.zeros(0, dtype=np.float64)))


def _finalize(inst, comp, out, executor) -> BackfillResult:
    job_comp: dict[int, float] = {}
    for (jid, _), t in comp.items():
        job_comp[jid] = max(job_comp.get(jid, 0.0), t)
    for j in inst.jobs:  # jobs with no coflows
        job_comp.setdefault(j.jid, float(j.release))
    # makespan must be consistent with completions: zero-demand markers and
    # late releases count even though they transmit nothing
    makespan = max(comp.values(), default=0.0)
    return BackfillResult(Transcript(out), comp, job_comp, makespan, inst,
                          executor)


# --------------------------------------------------------------------------
# packet-level executor (exec="packet")
# --------------------------------------------------------------------------

class _PFlow:
    __slots__ = ("jid", "cid", "srcs", "dsts", "units", "rem", "total",
                 "rem_total", "eidx", "packet_end")

    def __init__(self, jid, cid, srcs, dsts, units):
        self.jid, self.cid = jid, cid
        self.srcs, self.dsts, self.units = srcs, dsts, units
        self.rem = units.copy()
        self.total = float(units.sum())
        self.rem_total = self.total
        self.eidx = {(int(s), int(r)): k
                     for k, (s, r) in enumerate(zip(srcs, dsts))}
        self.packet_end = 0.0  # planned packet-exact completion


def _packet_sweep(sched: CompositeSchedule, fill: bool) -> BackfillResult:
    inst = sched.instance
    m = inst.m
    by_id, parents, topo = _job_maps(inst)

    # one planned ledger entry per coflow (top-level schedules guarantee
    # this); the ledger supplies the demand, the decomposition the timing
    plan: dict[tuple[int, int], _PFlow] = {}
    for p in sched.parts:
        for e in p.ledger:
            key = (e.jid, e.cid)
            assert key not in plan, "expected one ledger entry per coflow"
            plan[key] = _PFlow(e.jid, e.cid, e.srcs.astype(np.int64),
                               e.dsts.astype(np.int64),
                               e.units.astype(np.float64))
    # the parts planned without decompose=True build their per-coflow
    # decomposition here: every part's fix-up intervals in one batch on
    # the plan's device (equal to each part's coflow_intervals())
    decompose_parts(sched.parts)
    segs = EdgeIntervals.concat([p.coflow_intervals() for p in sched.parts])

    # map each planned segment row to its flow + demand-edge index
    row_flow: list[_PFlow] = []
    row_eidx: list[int] = []
    for i in range(segs.size):
        f = plan[(int(segs.jid[i]), int(segs.cid[i]))]
        row_flow.append(f)
        row_eidx.append(f.eidx[(int(segs.s[i]), int(segs.r[i]))])
        f.packet_end = max(f.packet_end, float(segs.t1[i]))

    out: list[TranscriptEntry] = []
    comp: dict[tuple[int, int], float] = {}
    is_zero = {key for key, f in plan.items() if f.total <= 0}
    # fill priority: earliest planned (packet-exact) completion first
    pending = sorted((f for f in plan.values() if f.total > 0),
                     key=lambda f: (f.packet_end, f.jid, f.cid))

    # Starts-After state, evaluated at interval ENTRY (a parent finishing
    # within [a, b) unblocks its children from the next interval on); a
    # zero-demand coflow counts as finished only once all its parents do —
    # precedence through empty coflows is transitive
    finished: set[tuple[int, int]] = set()

    def propagate_zero() -> None:
        changed = True
        while changed:
            changed = False
            for key in is_zero:
                if key in finished:
                    continue
                jid, cid = key
                if all((jid, q) in finished for q in parents[jid][cid]):
                    finished.add(key)
                    changed = True

    propagate_zero()

    if segs.size:
        events = np.unique(np.concatenate([segs.t0, segs.t1]))
        si = np.searchsorted(events, segs.t0)
        ei = np.searchsorted(events, segs.t1)
        K = events.size - 1
        add_at: list[list[int]] = [[] for _ in range(K + 1)]
        rem_at: list[list[int]] = [[] for _ in range(K + 1)]
        for i in range(segs.size):
            add_at[si[i]].append(i)
            rem_at[ei[i]].append(i)
    else:
        events = np.zeros(0, dtype=np.int64)
        K = 0
        add_at = rem_at = []

    active: set[int] = set()
    for k in range(K):
        for i in rem_at[k]:
            active.discard(i)
        for i in add_at[k]:
            active.add(i)
        a = float(events[k])
        b = float(events[k + 1])
        L = b - a
        slack_s = np.full(m, L, dtype=np.float64)
        slack_r = np.full(m, L, dtype=np.float64)
        newly: list[tuple[int, int]] = []

        # 1) planned transmissions — the active segments form a matching
        #    (the decomposition is a refinement of timed matchings), so
        #    planned service is never capacity-capped; a segment whose flow
        #    was already finished early by filling frees its ports
        touched: dict[tuple[int, int], list[tuple[int, float]]] = {}
        for i in sorted(active):
            f = row_flow[i]
            if f.rem_total <= 1e-9:
                continue
            kedge = row_eidx[i]
            x = min(L, float(f.rem[kedge]))
            if x <= 1e-12:
                continue
            slack_s[f.srcs[kedge]] -= x
            slack_r[f.dsts[kedge]] -= x
            touched.setdefault((f.jid, f.cid), []).append((kedge, x))
        assert slack_s.min(initial=0.0) > -1e-9 and \
            slack_r.min(initial=0.0) > -1e-9, \
            "planned segments exceeded port capacity (decomposition bug)"
        for key, lst in touched.items():
            f = plan[key]
            idx = np.array([k_ for k_, _ in lst], dtype=np.int64)
            amt = np.array([x for _, x in lst], dtype=np.float64)
            f.rem[idx] -= amt
            f.rem_total = float(f.rem.sum())
            out.append(TranscriptEntry(f.jid, f.cid, a, b,
                                       f.srcs[idx], f.dsts[idx], amt))
            if f.rem_total <= 1e-9:
                comp[key] = b
                newly.append(key)

        # 2) backfill into leftover capacity
        if fill and slack_s.max(initial=0.0) > 1e-9 \
                and slack_r.max(initial=0.0) > 1e-9:
            for f in pending:
                if f.rem_total <= 1e-9:
                    continue
                if by_id[f.jid].release > a + 1e-9:
                    continue
                key = (f.jid, f.cid)
                if not all((f.jid, q) in finished
                           for q in parents[f.jid][f.cid]):
                    continue
                amount = _cap_to_slack(f.rem.copy(), f.srcs, f.dsts,
                                       slack_s, slack_r)
                if amount.sum() <= 1e-12:
                    continue
                f.rem -= amount
                f.rem_total = float(f.rem.sum())
                out.append(TranscriptEntry(f.jid, f.cid, a, b,
                                           f.srcs, f.dsts, amount))
                if f.rem_total <= 1e-9:
                    comp[key] = b
                    newly.append(key)
                if slack_s.max(initial=0.0) <= 1e-9 or \
                        slack_r.max(initial=0.0) <= 1e-9:
                    break
        if newly:
            finished.update(newly)
            propagate_zero()
            pending = [f for f in pending if f.rem_total > 1e-9]

    # planned service is delivered in full, so no drain phase exists: the
    # executor finishes no later than the plan, pointwise
    assert all(f.rem_total <= 1e-6 for f in plan.values()), \
        "packet backfill lost demand"
    _stamp_zero_demand(inst, parents, topo, is_zero, comp, out)
    return _finalize(inst, comp, out, "packet")


# --------------------------------------------------------------------------
# ledger executor (exec="ledger")
# --------------------------------------------------------------------------

def _ledger_sweep(sched: CompositeSchedule, fill: bool) -> BackfillResult:
    inst = sched.instance
    m = inst.m
    by_id, parents, topo = _job_maps(inst)

    # one planned ledger entry per coflow (top-level schedules guarantee this)
    plan: dict[tuple[int, int], "_Flow"] = {}
    for p in sched.parts:
        for e in p.ledger:
            key = (e.jid, e.cid)
            assert key not in plan, "expected one ledger entry per coflow"
            plan[key] = _Flow(e.jid, e.cid, float(e.e0), float(e.e1),
                              e.srcs.astype(np.int64), e.dsts.astype(np.int64),
                              e.units.astype(np.float64))

    events = sorted({t for f in plan.values() for t in (f.e0, f.e1)})
    out: list[TranscriptEntry] = []
    comp: dict[tuple[int, int], float] = {}
    is_zero = {key for key, f in plan.items() if f.total <= 0}
    order_by_planned_end = sorted(plan.values(), key=lambda f: (f.e1, f.jid, f.cid))

    def process(a: float, b: float, fill_now: bool = True) -> None:
        L = b - a
        slack_s = np.full(m, L, dtype=np.float64)
        slack_r = np.full(m, L, dtype=np.float64)
        # Starts-After is evaluated against the state AT INTERVAL ENTRY: a
        # parent finishing within [a, b) unblocks its children only from the
        # next interval on (capacity capping can defer a parent past its
        # planned window, so this must be re-checked at execution time);
        # a zero-demand coflow counts as finished only once all its parents
        # do — precedence through empty coflows is transitive
        done_at_entry = {key: f.rem_total <= 1e-9 and key not in is_zero
                         for key, f in plan.items()}
        for j in inst.jobs:
            for cid in topo[j.jid]:
                key = (j.jid, cid)
                if key in is_zero:
                    done_at_entry[key] = all(done_at_entry[(j.jid, q)]
                                             for q in parents[j.jid][cid])

        def ready(f) -> bool:
            return all(done_at_entry[(f.jid, q)]
                       for q in parents[f.jid][f.cid])

        # 1) planned transmissions
        for f in order_by_planned_end:
            if f.rem_total <= 1e-9 or f.e0 >= b or f.e1 <= a:
                continue
            if not ready(f):
                continue
            frac = (min(b, f.e1) - max(a, f.e0)) / (f.e1 - f.e0)
            amount = np.minimum(f.units * frac, f.rem)
            # respect port capacity exactly (ledger rates can locally exceed it)
            amount = _cap_to_slack(amount, f.srcs, f.dsts, slack_s, slack_r)
            if amount.sum() <= 0:
                continue
            f.apply(amount)
            out.append(TranscriptEntry(f.jid, f.cid, a, b, f.srcs, f.dsts, amount))
            if f.rem_total <= 1e-9:
                comp[(f.jid, f.cid)] = b
        # 2) backfill into leftover capacity
        if not fill_now:
            return
        if slack_s.max(initial=0) <= 1e-9 and slack_r.max(initial=0) <= 1e-9:
            return
        for f in order_by_planned_end:
            if f.rem_total <= 1e-9 or f.total <= 0:
                continue
            job = by_id[f.jid]
            if job.release > a + 1e-9:
                continue
            if not ready(f):
                continue
            amount = _cap_to_slack(f.rem.copy(), f.srcs, f.dsts, slack_s, slack_r)
            if amount.sum() <= 1e-12:
                continue
            f.apply(amount)
            out.append(TranscriptEntry(f.jid, f.cid, a, b, f.srcs, f.dsts, amount))
            if f.rem_total <= 1e-9:
                comp[(f.jid, f.cid)] = b

    for a, b in zip(events[:-1], events[1:]):
        if b > a:
            process(a, b, fill_now=fill)

    # drain: capacity-capped planned units can spill past the last planned
    # window; keep offering full capacity until everything is transmitted
    # (progress is guaranteed: a topologically-first unfinished coflow of a
    # released job is always eligible).  The drain always fills — with no
    # planned windows left, filling is the only way leftovers move, so the
    # fill=False comparator differs only during the planned timeline.
    t = events[-1] if events else 0.0
    drain_len = max((f.rem_total for f in plan.values()), default=0.0)
    guard = 0
    while any(f.rem_total > 1e-9 for f in plan.values()):
        guard += 1
        assert guard < 10 * max(len(plan), 1), "backfill drain stalled (bug)"
        process(t, t + max(drain_len, 1.0))
        t += max(drain_len, 1.0)

    assert all(f.rem_total <= 1e-6 for f in plan.values()), "backfill lost demand"
    _stamp_zero_demand(inst, parents, topo, is_zero, comp, out)
    return _finalize(inst, comp, out, "ledger")


class _Flow:
    __slots__ = ("jid", "cid", "e0", "e1", "srcs", "dsts", "units", "rem",
                 "total", "rem_total")

    def __init__(self, jid, cid, e0, e1, srcs, dsts, units):
        self.jid, self.cid, self.e0, self.e1 = jid, cid, e0, e1
        self.srcs, self.dsts, self.units = srcs, dsts, units
        self.rem = units.copy()
        self.total = float(units.sum())
        self.rem_total = self.total

    def apply(self, amount: np.ndarray) -> None:
        self.rem -= amount
        self.rem_total = float(self.rem.sum())


def _cap_to_slack(
    want: np.ndarray, srcs: np.ndarray, dsts: np.ndarray,
    slack_s: np.ndarray, slack_r: np.ndarray,
) -> np.ndarray:
    """Greedy per-edge cap: amount <= min(want, sender slack, receiver slack),
    updating slacks in place.  The inner loop of every sweep interval.

    Greedy edge ORDER only matters when edges share a port AND capacity
    binds there, so two vectorized fast paths return exactly the scalar
    loop's result: (A) per-port grouped demand fits inside the slack
    everywhere — take everything; (B) every port appears at most once —
    edges are independent, elementwise min.  Anything else (shared port
    with binding capacity) falls back to the sequential scalar loop."""
    got = np.zeros_like(want)
    act = np.flatnonzero(want > 1e-12)
    if act.size == 0:
        return got
    w = want[act]
    s = srcs[act]
    r = dsts[act]
    # (A) nothing binds: grouped per-port sums all fit
    tot_s = np.zeros_like(slack_s)
    tot_r = np.zeros_like(slack_r)
    np.add.at(tot_s, s, w)
    np.add.at(tot_r, r, w)
    if (tot_s <= slack_s).all() and (tot_r <= slack_r).all():
        got[act] = w
        np.subtract.at(slack_s, s, w)
        np.subtract.at(slack_r, r, w)
        return got
    # (B) conflict-free: ports distinct, edges independent
    if np.unique(s).size == s.size and np.unique(r).size == r.size:
        x = np.minimum(w, np.minimum(slack_s[s], slack_r[r]))
        x[x <= 1e-12] = 0.0
        got[act] = x
        slack_s[s] -= x
        slack_r[r] -= x
        return got
    _cap_to_slack_scalar(want, srcs, dsts, slack_s, slack_r, got)
    return got


def _cap_to_slack_scalar(
    want: np.ndarray, srcs: np.ndarray, dsts: np.ndarray,
    slack_s: np.ndarray, slack_r: np.ndarray, got: np.ndarray | None = None,
) -> np.ndarray:
    """Sequential greedy reference (edges share ports; order matters)."""
    if got is None:
        got = np.zeros_like(want)
    for k in range(want.size):
        if want[k] <= 0:
            continue
        s, r = srcs[k], dsts[k]
        x = min(want[k], slack_s[s], slack_r[r])
        if x > 1e-12:
            got[k] = x
            slack_s[s] -= x
            slack_r[r] -= x
    return got

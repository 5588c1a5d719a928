"""Event-driven scheduling session — the paper's §VII-C.2 protocol as a
stateful API; the port of ``repro.core.session``.

The online protocol is inherently event-driven: arrivals suspend the active
plan and trigger a reschedule over residual demand.  ``SchedulerSession``
exposes exactly that shape —

    session = SchedulerSession(m, "gdm", device="cuda", seed=0)
    session.submit(job)          # enqueue an arrival (release may be future)
    session.advance(until=t)     # execute the active plan up to wall-clock t
    session.frontier()           # live view: planned completions, busy end
    session.snapshot()           # residual-demand ledger, for introspection
    session.result()             # OnlineResult once everything drained

— and owns the two pieces of state that previously lived as locals inside
``simulate_online``: the **residual-demand ledger** (integer packets
remaining per coflow edge) and the **cumulative-flooring executor** (partial
plan windows bank integer packets against a running fractional total, so
backfilled transcripts cannot livelock the reschedule loop).
``simulate_online`` and ``engine.plan_online`` are thin, results-identical
drivers over a session; the historical closed batch loop is retained as
``simulate_online(..., driver="batch")``, the reference comparator.

Plan repair (frontier append)
-----------------------------
A ``submit`` normally invalidates the active plan and the next ``advance``
replans the full residual instance (the paper's protocol).  When the
arrival *only appends work past the current frontier*, the session instead
splices the new job into the retained merge-and-fix expansion
(``FinalSchedule.spliced``) and plans only the new job — incremental
plan repair.  The fast path fires only when it is provably
results-identical to the full replan, which currently means the
job-sequential ``om_alg`` scheduler with:

* every unfinished coflow untouched since the epoch's plan (its residual
  demand bit-equal to the plan-time demand — the arrival landed on a clean
  cut of the sequential schedule);
* the Algorithm 5 order of the new residual instance keeping the retained
  jobs in their planned order with every new job appended at the tail;
* the retained ledger windows equal to the windows a from-scratch
  ``om_alg`` replan would emit (checked structurally: back-to-back
  effective-size windows in topological order — this check is what makes
  the path self-verifying rather than trusted).

Spread-mode G-DM and G-DM-RT (``delays="spread"``) take a group-aware
variant of the fast path: their delays are deterministic (zero rng draws),
so a DMA/DMA-SRT group layout is a pure function of the group's member
jobs and residual demands, and it is translation invariant —
``dma(jobs, origin=o)`` is ``dma(jobs, origin=0)`` slid by ``o``.  The
repair therefore re-derives the Algorithm 5 order and geometric grouping
of the residual instance and walks the replan's group chain: a retained
group whose membership matches an old group verbatim and whose residuals
are bit-equal to the plan-time snapshot is **reused as one block**, slid
from its old chain position to the one the replan would assign
(``FinalSchedule.shifted_expanded`` — sound at *any* integer offset by
translation invariance, not just the aligned ``origin == tau + cursor``
position the legacy gate demands) — including non-singleton and
expanded (alpha > 1) groups; every other group (the in-flight group an
arrival interrupted, groups whose membership changed, groups holding new
jobs) is rebuilt through the backend's **group-block cache**
(``backend.group_block``): the exact spread-mode ``dma``/``dma_rt``
construction — including DMA-SRT's forest/start-after-parents fallback —
built once at origin 0 and slid into place.  The result is bit-identical
to the full replan by construction; the repair is counted as a hit when
at least one block was reused, and per-group reuse counts land in
``SessionStats.groups_reused`` / ``groups_replanned``.  Randomized
G-DM/G-DM-RT always fall back (their delays re-draw per plan).
Repair/replan counts, the repair hit rate, and warm-replan wall-clock are
reported in :class:`SessionStats` alongside the engine's BNA/order cache
stats.  ``repair="legacy"`` keeps the pre-generalization gate (om_alg +
singleton spread-mode G-DM, whole plan retained at its aligned position)
for before/after hit-rate comparisons.

Pinned gamma (``gamma="pinned"``)
---------------------------------
Even with the grouped certification, the repair fires rarely in pure mode
because the *geometric grouping itself* drifts: the paper's gamma is the
residual instance's min positive flow size, which changes on nearly every
arrival and re-buckets every retained job.  ``gamma="pinned"`` hands
ownership of gamma to the session: a :class:`~repro_torch.core.gdm.GammaEpoch`
pins the first residual's natural gamma and thereafter rescales
monotonically downward by powers of two only when a later residual's
natural gamma drops below the pin (counted in
``SessionStats.gamma_rescales``; the grouping analysis holds up to the
pin's bounded ratio — see core/gdm.py).  The pin is observed once per
planning event from the residual instance — a pure function of the
residual sequence, replicated verbatim by ``simulate_online``'s batch
driver, so stream-vs-batch bit-identity is preserved — and threaded to
both the repair's ``group_jobs`` call and the full replan
(``plan_full(sub, gamma=...)``).  ``gamma=<positive int/Fraction>`` pins
a fixed value instead; ``gamma="residual"`` (default) keeps the paper's
per-residual gamma.  Pinning requires an engine scheduler whose factory
takes the ``gamma`` plan option (the G-DM family); the epoch state rides
along in :class:`SessionSnapshot` so kill-and-resume keeps the pin.

Backpressure (sustained arrivals)
---------------------------------
Under sustained arrivals, full replans are the expensive event: when too
many recent reschedules missed the repair path, a serving layer should
stop admitting work mid-window and wait for a clean cut.  The session
tracks exactly that signal: ``replan_debt`` is the full-replan fraction
over a sliding window of recent reschedules, and with an
:class:`AdmissionPolicy` attached, :meth:`SchedulerSession.backpressure`
turns on once the debt exceeds ``replan_budget`` (after ``window // 2``
reschedules of warm-up).  The policy also carries ``max_pending``, the
bound on the *caller's* deferred-arrivals queue — ``core.stream`` defers
arrivals to the next planned completion boundary while backpressure holds
and rejects beyond the bound, and ``serve.engine`` holds its admission
queue under the same signal; deferral/reject counts are surfaced in
``SessionStats.admission_deferred`` / ``admission_rejects``.

Engine-backed planning events prefetch the whole residual instance's
decompositions in one batched call — ``backend.prefetch_plan``, issued
inside ``plan_full``; it dispatches to the pipeline (``bna_decompose`` per
width bucket) or to ``bna_pieces_many`` (``bna_step``) per the session's
plan backend — before the scheduler walks jobs one by one — the engine's
instance-level batching (see ``core/matching.py``); the repair path
prefetches the newly-arrived jobs the same way.  Plain-callable schedulers
are left unprefetched (the session cannot know whether they decompose
demands at all).

Device and plan backend
-----------------------
A session plans on ``device`` (default ``"cuda"``; ``"cpu"`` runs the
kernels' plain versions) through ``plan_backend`` (``"pipeline"`` or
``"python"``; None takes the device's default), and hands both to
``make_scheduler``, to the repair's ``prefetch_plan``, ``group_block`` and
``merge_and_fix``.  A prebuilt engine scheduler brings its own, and must
agree with the session's.  The residual ledger, the snapshots and the
frontier are host numpy, as in the reference, so a snapshot taken on one
device restores on the other and carries on bit-identically: every device
and plan backend plans the same integers.
"""
from __future__ import annotations

import dataclasses
import math
import time
from bisect import insort
from dataclasses import dataclass, field

import numpy as np
import torch

from .result import CompositeSchedule, Transcript
from .types import Coflow, Instance, Job, effective_size, topological_order

__all__ = [
    "AdmissionPolicy",
    "SchedulerSession",
    "SessionStats",
    "Frontier",
    "SessionSnapshot",
    "sub_instance",
    "execute_transcript",
]

_EPS = 1e-9


# --------------------------------------------------------------------------
# the residual-demand machinery (previously simulate_online's locals)
# --------------------------------------------------------------------------

def sub_instance(
    active: list[Job],
    remaining: dict[tuple[int, int], np.ndarray],
    done: dict[tuple[int, int], float],
    m: int,
) -> tuple[Instance, dict[int, list[int]]]:
    """Remaining-demand instance at a rescheduling point; all jobs present
    (release 0). cid_maps[jid] maps sub-instance cid -> original cid."""
    sub_jobs: list[Job] = []
    cid_maps: dict[int, list[int]] = {}
    for j in active:
        keep = [c.cid for c in j.coflows if (j.jid, c.cid) not in done]
        if not keep:
            continue
        idx = {orig: k for k, orig in enumerate(keep)}
        coflows = [Coflow(j.jid, idx[orig], remaining[(j.jid, orig)]) for orig in keep]
        edges = [(idx[a], idx[b]) for a, b in j.edges if a in idx and b in idx]
        sub_jobs.append(Job(j.jid, coflows, edges, weight=j.weight, release=0))
        cid_maps[j.jid] = keep
    return Instance(m, sub_jobs), cid_maps


def execute_transcript(
    transcript: Transcript,
    horizon: float,
    t0_abs: float,
    cid_maps: dict[int, list[int]],
    remaining: dict[tuple[int, int], np.ndarray],
    done: dict[tuple[int, int], float],
) -> None:
    """Apply transcript (local time) up to `horizon`; floor partial windows.

    Flooring is *cumulative* per coflow edge, not per entry: backfilled
    transcripts split a flow's units fractionally across many windows, and
    flooring each window independently can yield zero progress forever
    (0.5 + 0.5 -> 0 + 0), livelocking the reschedule loop.  Accumulating
    the fractional units and banking integer packets whenever the running
    total crosses an integer keeps partial windows conservative while
    guaranteeing progress (the 1e-6 slack absorbs the backfill sweep's
    conservation tolerance)."""
    acc: dict[tuple[int, int], np.ndarray] = {}
    banked: dict[tuple[int, int], np.ndarray] = {}
    for e in sorted(transcript.entries, key=lambda e: e.t1):
        if e.units.size == 0:
            if e.t1 <= horizon + _EPS:
                key = (e.jid, cid_maps[e.jid][e.cid])
                done.setdefault(key, t0_abs + e.t1)
            continue
        if e.t0 >= horizon:
            continue
        if e.t1 <= horizon + _EPS:
            amount = e.units
            end = e.t1
        else:
            frac = (horizon - e.t0) / (e.t1 - e.t0)
            amount = np.floor(e.units * frac)
            end = horizon
        key = (e.jid, cid_maps[e.jid][e.cid])
        rem = remaining[key]
        a = acc.setdefault(key, np.zeros_like(rem, dtype=np.float64))
        t = banked.setdefault(key, np.zeros_like(rem))
        a[e.srcs, e.dsts] += amount
        cur = a[e.srcs, e.dsts]
        if cur.size and float(cur.max()) >= 2.0**53:
            # past 2^53 float64 drops integer precision and the banked
            # floor could silently lose (or invent) packets
            raise ValueError(
                "cumulative edge units exceed the float64 integer-exact "
                f"range (2^53) for job {e.jid} coflow {e.cid}")
        avail = np.floor(cur + 1e-6).astype(np.int64) \
            - t[e.srcs, e.dsts]
        take = np.minimum(np.maximum(avail, 0), rem[e.srcs, e.dsts])
        t[e.srcs, e.dsts] += take
        rem[e.srcs, e.dsts] -= take
        if rem.sum() == 0 and key not in done:
            done[key] = t0_abs + end


# --------------------------------------------------------------------------
# public session state views
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class AdmissionPolicy:
    """Replan-budget backpressure policy for sustained arrivals.

    ``replan_budget`` is the tolerated full-replan fraction over the last
    ``window`` reschedules (the session's ``replan_debt``); above it,
    :meth:`SchedulerSession.backpressure` turns on and admission layers
    (``core.stream``, ``serve.engine``) hold arrivals for the next clean
    cut.  ``max_pending`` bounds the caller's deferred-arrivals queue —
    past it, arrivals are rejected (counted in
    ``SessionStats.admission_rejects``)."""

    max_pending: int = 64
    replan_budget: float = 0.5
    window: int = 32

    def __post_init__(self):
        if not (isinstance(self.max_pending, int) and self.max_pending >= 1):
            raise ValueError(f"max_pending must be a positive int, "
                             f"got {self.max_pending!r}")
        if not 0.0 <= self.replan_budget <= 1.0:
            raise ValueError(f"replan_budget must be in [0, 1], "
                             f"got {self.replan_budget!r}")
        if not (isinstance(self.window, int) and self.window >= 2):
            raise ValueError(f"window must be an int >= 2, "
                             f"got {self.window!r}")


@dataclass
class SessionStats:
    """Planning-side counters for one session.

    ``reschedules`` counts every planning event; ``repairs`` of those took
    the frontier-append fast path, ``full_replans`` planned the residual
    instance from scratch, and ``repair_rejects`` attempted the fast path
    but failed a soundness check (and fell back — they are counted inside
    ``full_replans`` too).  The grouped repair path (spread-mode G-DM /
    G-DM-RT) additionally counts reused vs recomputed geometric groups;
    ``gamma_rescales`` is the pinned-gamma epoch's cumulative power-of-two
    downscale count (0 under ``gamma="residual"``);
    ``replan_debt`` is the windowed full-replan fraction the
    :class:`AdmissionPolicy` compares against its budget, and
    ``admission_deferred`` / ``admission_rejects`` count arrivals the
    admission layer held for a clean cut / dropped at the queue bound."""

    reschedules: int = 0
    full_replans: int = 0
    repairs: int = 0
    repair_rejects: int = 0
    groups_reused: int = 0
    groups_replanned: int = 0
    gamma_rescales: int = 0
    admission_deferred: int = 0
    admission_rejects: int = 0
    replan_debt: float = 0.0
    plan_wall_s: float = 0.0
    first_plan_wall_s: float = 0.0
    repair_wall_s: float = 0.0

    @property
    def repair_hit_rate(self) -> float:
        return self.repairs / self.reschedules if self.reschedules else 0.0

    @property
    def warm_replan_wall_s(self) -> float:
        """Wall-clock spent planning after the cold first plan."""
        return max(self.plan_wall_s - self.first_plan_wall_s, 0.0)

    def as_dict(self) -> dict:
        return {
            "reschedules": self.reschedules,
            "full_replans": self.full_replans,
            "repairs": self.repairs,
            "repair_rejects": self.repair_rejects,
            "repair_hit_rate": self.repair_hit_rate,
            "groups_reused": self.groups_reused,
            "groups_replanned": self.groups_replanned,
            "gamma_rescales": self.gamma_rescales,
            "admission_deferred": self.admission_deferred,
            "admission_rejects": self.admission_rejects,
            "replan_debt": self.replan_debt,
            "plan_wall_s": self.plan_wall_s,
            "first_plan_wall_s": self.first_plan_wall_s,
            "warm_replan_wall_s": self.warm_replan_wall_s,
            "repair_wall_s": self.repair_wall_s,
        }


@dataclass
class Frontier:
    """The session's live planning frontier at wall-clock ``now``.

    ``completions`` maps every job with unfinished work to its *planned*
    absolute completion under the active plan; ``finished`` maps drained
    jobs to their actual completion (a live VIEW of session state, not a
    copy — treat it as read-only); ``pending`` lists submitted jobs whose
    release is still in the future.  ``busy_until`` is the absolute end of
    the currently planned work (== ``now`` when the system is idle)."""

    now: float
    busy_until: float
    completions: dict[int, float]
    finished: dict[int, float]
    pending: tuple[int, ...]

    def completion(self, jid: int, default: float = math.inf) -> float:
        """Planned (active) or actual (finished) completion of a job."""
        if jid in self.completions:
            return self.completions[jid]
        return self.finished.get(jid, default)

    def order(self) -> list[int]:
        """Active + finished jids by (planned or actual) completion."""
        known = {**self.finished, **self.completions}
        return sorted(known, key=lambda jid: (known[jid], jid))


@dataclass
class SessionSnapshot:
    """Deep-copied view of the session's residual-demand ledger.  Carries
    everything :meth:`SchedulerSession.restore` needs (besides the Job
    objects themselves) to continue bit-identically after a driver kill."""

    now: float
    m: int
    submitted: tuple[int, ...]
    active: tuple[int, ...]           # jids with unfinished work
    pending: tuple[int, ...]          # jids not yet released
    remaining: dict[tuple[int, int], np.ndarray]
    done: dict[tuple[int, int], float]
    reschedules: int
    gamma_epoch: tuple | None = None   # GammaEpoch.state(), for pinned gamma

    def remaining_total(self) -> int:
        return int(sum(int(r.sum()) for r in self.remaining.values()))


# --------------------------------------------------------------------------
# epoch (one plan's lifetime between reschedules)
# --------------------------------------------------------------------------

@dataclass
class _Epoch:
    t0: float                          # absolute plan time
    transcript: Transcript
    cid_maps: dict[int, list[int]]
    sub: Instance
    plan: "object | None"              # engine PlanResult when available
    base_remaining: dict[tuple[int, int], np.ndarray]
    exec_horizon: float = 0.0          # relative horizon executed so far
    completions: dict[int, float] = field(default_factory=dict)

    _busy_end: float | None = None

    @property
    def busy_end(self) -> float:
        """Relative end of the last transcript entry; past this the epoch is
        fully executed and further advances are no-ops."""
        if self._busy_end is None:
            self._busy_end = max((e.t1 for e in self.transcript.entries),
                                 default=0.0)
        return self._busy_end


class SchedulerSession:
    """One stateful scheduling surface for offline, online, and serving-time
    coflow scheduling (see module docstring)."""

    def __init__(self, m: int, scheduler="gdm", *, repair: "bool | str" = True,
                 admission: AdmissionPolicy | None = None,
                 gamma: "str | int | object" = "residual",
                 device: "str | torch.device" = "cuda",
                 plan_backend: "str | None" = None, **opts):
        from ..kernels import resolve_device
        from . import backend
        from .gdm import GammaEpoch

        self.m = int(m)
        self.device = resolve_device(device)
        if repair not in (True, False, "legacy"):
            raise ValueError(f"repair must be True, False, or 'legacy', "
                             f"got {repair!r}")
        self.repair = repair
        self.admission = admission
        self._gamma_epoch = GammaEpoch.from_policy(gamma)
        window = admission.window if admission is not None else 32
        self._recent_outcomes: list[int] = []   # 1 = full replan, 0 = repair
        self._recent_window = window
        self._scheduler_name = scheduler if isinstance(scheduler, str) \
            else getattr(scheduler, "name", None)
        home = getattr(scheduler, "device", None)
        if home is not None and plan_backend is None:
            plan_backend = scheduler.plan_backend   # a prebuilt scheduler's
        self.plan_backend = backend.resolve_plan_backend(plan_backend,
                                                         self.device)
        if isinstance(scheduler, str):
            from .engine import make_scheduler

            scheduler = make_scheduler(scheduler, device=self.device,
                                       plan_backend=self.plan_backend,
                                       **opts)
        elif opts:
            raise TypeError("scheduler options are only accepted with a "
                            "scheduler name, not a prebuilt scheduler")
        elif home is not None and (
                torch.device(home) != self.device
                or scheduler.plan_backend != self.plan_backend):
            raise ValueError(
                f"the prebuilt scheduler plans on {home} through "
                f"{scheduler.plan_backend!r}, the session on {self.device} "
                f"through {self.plan_backend!r}")
        self._scheduler = scheduler
        if self._gamma_epoch is not None:
            from .engine import scheduler_options

            try:
                gamma_ok = isinstance(self._scheduler_name, str) and \
                    "gamma" in scheduler_options(self._scheduler_name)
            except KeyError:
                gamma_ok = False
            if not gamma_ok:
                raise ValueError(
                    f"gamma={gamma!r} needs an engine scheduler taking the "
                    f"'gamma' plan option (the G-DM family); "
                    f"got {self._scheduler_name!r}")
        self._jobs: list[Job] = []                     # submission order
        self._by_jid: dict[int, Job] = {}
        self._pending: list[tuple[float, int, Job]] = []   # (release, jid, job)
        self._active: list[Job] = []
        self._finished: dict[int, float] = {}          # drained jid -> completion
        self._remaining: dict[tuple[int, int], np.ndarray] = {}
        self._done: dict[tuple[int, int], float] = {}
        self._t = 0.0
        self._dirty = False
        self._arrived_since_plan: list[Job] = []
        self._epoch: _Epoch | None = None
        self._last_plan = None                         # last engine PlanResult
        self.stats = SessionStats()
        self._cache_before = backend.cache_stats()

    @classmethod
    def restore(cls, snapshot: SessionSnapshot, jobs: list[Job], scheduler="gdm",
                *, repair: "bool | str" = True,
                admission: AdmissionPolicy | None = None,
                gamma: "str | int | object" = "residual",
                device: "str | torch.device" = "cuda",
                plan_backend: "str | None" = None,
                **opts) -> "SchedulerSession":
        """Rebuild a session from a :meth:`snapshot` plus the submitted Job
        objects — the kill-and-resume path.  The restored session holds the
        same residual-demand ledger and completion stamps; its first
        planning event is a full replan of the residual instance (the
        retained expansion is not serialized), which the repair
        certification already guarantees is results-identical — so a stream
        resumed from a snapshot taken at an arrival event continues
        bit-identically (the port's stream tests prove it across the
        online matrix).  Stats counters restart from zero — except the gamma
        epoch, which resumes from ``snapshot.gamma_epoch`` (pin AND
        cumulative rescale count) when the restored session also pins, so
        the grouping scale continues exactly where the killed session left
        it.  The snapshot is host data, so the restored session may plan on
        another device or plan backend than the one that took it."""
        s = cls(snapshot.m, scheduler, repair=repair, admission=admission,
                gamma=gamma, device=device, plan_backend=plan_backend,
                **opts)
        if s._gamma_epoch is not None and not s._gamma_epoch.fixed \
                and snapshot.gamma_epoch is not None:
            from .gdm import GammaEpoch

            s._gamma_epoch = GammaEpoch.from_state(snapshot.gamma_epoch)
        by_jid = {j.jid: j for j in jobs}
        missing = [jid for jid in snapshot.submitted if jid not in by_jid]
        if missing:
            raise ValueError(f"restore needs every submitted job; "
                             f"missing jids {missing}")
        s._t = float(snapshot.now)
        pending = set(snapshot.pending)
        active = set(snapshot.active)
        for jid in snapshot.submitted:
            job = by_jid[jid]
            s._jobs.append(job)
            s._by_jid[jid] = job
        s._remaining = {k: v.copy() for k, v in snapshot.remaining.items()}
        s._done = dict(snapshot.done)
        s._active = [by_jid[jid] for jid in snapshot.submitted
                     if jid in active]
        for jid in snapshot.submitted:
            if jid in pending:
                job = by_jid[jid]
                insort(s._pending, (float(job.release), jid, job))
            elif jid not in active:
                job = by_jid[jid]
                cs = [s._done[(jid, c.cid)] for c in job.coflows
                      if (jid, c.cid) in s._done]
                s._finished[jid] = max(cs, default=float(job.release))
        s._dirty = bool(s._active)
        return s

    # --- basic views --------------------------------------------------------

    @property
    def now(self) -> float:
        return self._t

    @property
    def done(self) -> bool:
        """True once every submitted job has drained."""
        return not self._pending and not self._work_remaining()

    @property
    def last_plan(self):
        """The engine PlanResult of the most recent planning event (None for
        plain-callable schedulers, which expose only a transcript)."""
        return self._last_plan

    @property
    def replan_debt(self) -> float:
        """Full-replan fraction over the recent-reschedule window (0.0 while
        the window is empty) — the signal the admission policy budgets."""
        if not self._recent_outcomes:
            return 0.0
        return sum(self._recent_outcomes) / len(self._recent_outcomes)

    def backpressure(self) -> bool:
        """True when the attached :class:`AdmissionPolicy` says admission
        should hold arrivals for a clean cut: the windowed replan debt
        exceeds the replan budget.  Always False without a policy, and
        during the warm-up half-window (a single cold full replan must not
        stall admission)."""
        pol = self.admission
        if pol is None:
            return False
        if len(self._recent_outcomes) < max(2, pol.window // 2):
            return False
        return self.replan_debt > pol.replan_budget

    # --- event API ----------------------------------------------------------

    def submit(self, job: Job) -> None:
        """Enqueue an arrival.  A job released at or before ``now`` joins the
        active set immediately and suspends the current plan (the §VII-C.2
        protocol); a future release is admitted when ``advance`` reaches it."""
        if job.jid in self._by_jid:
            raise ValueError(f"job {job.jid} already submitted")
        if job.coflows and job.m != self.m:
            raise ValueError(f"job {job.jid} is on {job.m} ports, "
                             f"session on {self.m}")
        self._jobs.append(job)
        self._by_jid[job.jid] = job
        for c in job.coflows:
            rem = c.demand.astype(np.int64).copy()
            self._remaining[(job.jid, c.cid)] = rem
            if rem.sum() == 0:   # empty from the start: completes at release
                self._done[(job.jid, c.cid)] = float(job.release)
        if job.release <= self._t + _EPS:
            self._admit_job(job)
        else:
            insort(self._pending, (float(job.release), job.jid, job))

    def advance(self, until: float | None = None) -> float:
        """Run the event loop up to wall-clock ``until`` (None: drain every
        submitted job, jumping across idle gaps to future releases — the
        closed-batch behaviour).  Replans lazily whenever arrivals have
        suspended the active plan; returns the new ``now``."""
        if until is not None and until < self._t - _EPS:
            raise ValueError(f"cannot advance backwards "
                             f"(now={self._t}, until={until})")
        target = math.inf if until is None else float(until)
        drain = until is None
        while True:
            self._admit_due()
            self._prune_active()
            if not self._work_remaining():
                nxt = self._next_release()
                if nxt is not None and (drain or nxt <= target + _EPS):
                    self._t = max(self._t, nxt)   # idle jump to next arrival
                    continue
                break
            self._ensure_plan()
            nxt = self._next_release()
            horizon = min(target, nxt if nxt is not None else math.inf)
            self._execute_to(horizon)
            if math.isinf(horizon):
                # executed the full plan; land on the last completion and
                # loop around to drain any still-pending future releases
                self._t = max(self._t,
                              max(self._done.values(), default=self._t))
                continue
            self._t = max(self._t, horizon)
            if horizon >= target - _EPS:
                break
        if not drain:
            self._t = max(self._t, target)
        self._admit_due()   # arrivals landing exactly on `until` are due now
        return self._t

    def frontier(self) -> Frontier:
        """The live planning frontier.  Replans first if submissions have
        suspended the active plan (time does not move)."""
        if self._work_remaining():
            self._ensure_plan()
        self._prune_active()
        completions: dict[int, float] = {}
        busy = self._t
        if self._epoch is not None:
            for jid, t in self._epoch.completions.items():
                if jid not in self._finished:
                    completions[jid] = t
                    busy = max(busy, t)
        return Frontier(now=self._t, busy_until=busy, completions=completions,
                        finished=self._finished,
                        pending=tuple(jid for _, jid, _ in self._pending))

    def snapshot(self) -> SessionSnapshot:
        return SessionSnapshot(
            now=self._t,
            m=self.m,
            submitted=tuple(j.jid for j in self._jobs),
            active=tuple(j.jid for j in self._active if self._unfinished(j)),
            pending=tuple(jid for _, jid, _ in self._pending),
            remaining={k: v.copy() for k, v in self._remaining.items()},
            done=dict(self._done),
            reschedules=self.stats.reschedules,
            gamma_epoch=self._gamma_epoch.state()
            if self._gamma_epoch is not None else None,
        )

    def result(self):
        """OnlineResult over every submitted job; requires a drained session
        (``advance()`` with no ``until`` drains)."""
        from . import backend
        from .online import OnlineResult

        if not self.done:
            raise RuntimeError("result() before the session drained; call "
                               "advance() (no until) first, or inspect "
                               "snapshot()/frontier() mid-run")
        job_comp: dict[int, float] = {}
        for j in self._jobs:
            cs = [self._done[(j.jid, c.cid)] for c in j.coflows]
            job_comp[j.jid] = max(cs, default=float(j.release))
        stats: dict = {"session": self.stats.as_dict()}
        after = backend.cache_stats()
        for cache in ("bna", "order", "group"):
            hits = after[cache]["hits"] - self._cache_before[cache]["hits"]
            misses = after[cache]["misses"] - self._cache_before[cache]["misses"]
            total = hits + misses
            stats[cache] = {"hits": hits, "misses": misses,
                            "hit_rate": (hits / total) if total else 0.0}
        return OnlineResult(job_comp, Instance(self.m, list(self._jobs)),
                            self.stats.reschedules, stats)

    def backfilled_plan(self, exec: str = "packet"):
        """Backfill the current epoch's residual plan (§VII) without
        replanning — the session-aware entry into ``core.backfill``.
        Requires an engine scheduler (a plan, not just a transcript) and a
        plan that was not already backfilled."""
        from .backfill import backfill

        if self._work_remaining():
            self._ensure_plan()
        if self._epoch is None or self._epoch.plan is None:
            raise ValueError("no engine plan to backfill (idle session, or "
                             "a plain-callable scheduler)")
        return backfill(self._epoch.plan, exec=exec)

    # --- internals ----------------------------------------------------------

    def _admit_job(self, job: Job) -> None:
        self._active.append(job)
        self._arrived_since_plan.append(job)
        self._dirty = True

    def _admit_due(self) -> None:
        while self._pending and self._pending[0][0] <= self._t + _EPS:
            _, _, job = self._pending.pop(0)
            self._admit_job(job)

    def _next_release(self) -> float | None:
        return self._pending[0][0] if self._pending else None

    def _unfinished(self, job: Job) -> bool:
        return any((job.jid, c.cid) not in self._done for c in job.coflows)

    def _prune_active(self) -> None:
        """Retire drained jobs from the active set (their coflow residuals
        are all stamped done, so they contribute nothing to replans).  Keeps
        the per-tick cost of a long-lived session — the serving engine runs
        one per batch stream — proportional to the jobs still in flight,
        not to everything ever submitted."""
        still: list[Job] = []
        for j in self._active:
            if not j.coflows:   # nothing to transmit: complete at release
                self._finished[j.jid] = float(j.release)
            elif not self._unfinished(j):
                self._finished[j.jid] = max(self._done[(j.jid, c.cid)]
                                            for c in j.coflows)
            else:
                still.append(j)
        self._active = still

    def _work_remaining(self) -> bool:
        return any(self._remaining[(j.jid, c.cid)].sum() > 0
                   for j in self._active for c in j.coflows)

    def _ensure_plan(self) -> None:
        if not self._dirty and self._epoch is not None:
            return
        sub, cid_maps = sub_instance(self._active, self._remaining,
                                     self._done, self.m)
        if not sub.jobs:
            self._epoch = None
            self._dirty = False
            self._arrived_since_plan = []
            return
        pinned = None
        if self._gamma_epoch is not None:
            pinned = self._gamma_epoch.observe(sub.gamma())
            self.stats.gamma_rescales = self._gamma_epoch.rescales
        t0 = time.perf_counter()
        epoch = self._try_repair(sub, cid_maps, pinned)
        repaired = epoch is not None
        if repaired:
            wall = time.perf_counter() - t0
            self.stats.repairs += 1
            self.stats.repair_wall_s += wall
        else:
            plan, transcript = self._plan(sub, pinned)
            wall = time.perf_counter() - t0
            epoch = self._make_epoch(transcript, plan, cid_maps, sub)
            self.stats.full_replans += 1
        self._recent_outcomes.append(0 if repaired else 1)
        del self._recent_outcomes[:-self._recent_window]
        self.stats.replan_debt = self.replan_debt
        self.stats.reschedules += 1
        self.stats.plan_wall_s += wall
        if self.stats.reschedules == 1:
            self.stats.first_plan_wall_s = wall
        self._epoch = epoch
        self._dirty = False
        self._arrived_since_plan = []

    def _make_epoch(self, transcript: Transcript, plan,
                    cid_maps: dict[int, list[int]], sub: Instance) -> _Epoch:
        """Epoch state for a plan made NOW: the plan-time residual snapshot
        (re-execution baseline) and planned absolute completions.  Shared by
        the full-replan and repair paths so their epoch semantics cannot
        diverge."""
        return _Epoch(
            t0=self._t, transcript=transcript, cid_maps=cid_maps,
            sub=sub, plan=plan,
            base_remaining={(jid, orig): self._remaining[(jid, orig)].copy()
                            for jid in cid_maps for orig in cid_maps[jid]},
            completions={jid: self._t + t for jid, t in
                         transcript.job_completions().items()},
        )

    def _plan(self, sub: Instance, pinned=None):
        s = self._scheduler
        plan_full = getattr(s, "plan_full", None)
        if callable(plan_full):
            # engine path: plan_full prefetches itself; a pinned gamma
            # overrides the grouping scale for this event only
            p = plan_full(sub, gamma=pinned) if pinned is not None \
                else plan_full(sub)
            self._last_plan = p
            return p, p.transcript()
        # plain callables get NO speculative prefetch: the session cannot
        # know they decompose demands at all, and a non-BNA heuristic
        # would pay every coflow's decomposition for nothing.  BNA-based
        # callables still share the LRU scalar-style; register through the
        # engine to batch.
        plan = getattr(s, "plan", None)
        if callable(plan) and not isinstance(s, type):
            return None, plan(sub)
        return None, s(sub)

    def _execute_to(self, horizon_abs: float) -> None:
        """Execute the epoch's transcript up to absolute ``horizon_abs``.

        Execution is re-run from the epoch's plan-time snapshot each time,
        so the state after the *last* advance of an epoch is bit-identical
        to a single closed-batch execution at that horizon (the cumulative
        flooring bank is per-epoch, exactly as in the batch loop).  Mid-
        epoch advances are consistent intermediate snapshots; completion
        stamps keep their first (earliest-observed) value."""
        ep = self._epoch
        if ep is None:
            return
        h_rel = horizon_abs - ep.t0
        if h_rel <= ep.exec_horizon + _EPS:
            return
        if ep.exec_horizon >= ep.busy_end - _EPS:
            # epoch fully executed: nothing past busy_end can change state,
            # so ticking callers (serve advances every decode step) pay O(1)
            ep.exec_horizon = h_rel
            return
        rem = {k: v.copy() for k, v in ep.base_remaining.items()}
        local_done: dict[tuple[int, int], float] = {}
        execute_transcript(ep.transcript, h_rel, ep.t0, ep.cid_maps,
                           rem, local_done)
        for k, v in rem.items():
            self._remaining[k] = v
        for k, v in local_done.items():
            self._done.setdefault(k, v)
        ep.exec_horizon = h_rel

    # --- frontier-append plan repair ---------------------------------------

    def _try_repair(self, sub: Instance, cid_maps: dict[int, list[int]],
                    pinned=None):
        """Splice the newly-arrived jobs past the retained plan's frontier,
        when provably identical to a full replan (module docstring).
        Returns the repaired _Epoch, or None to fall back."""
        if not self.repair:
            return None
        name = self._scheduler_name
        opts = getattr(self._scheduler, "opts", None) or {}
        spread = opts.get("delays") == "spread"
        # om_alg is job-sequential by construction; spread-mode G-DM and
        # G-DM-RT are deterministic per group, so they take the group-aware
        # path below.  Randomized G-DM/G-DM-RT always fall back (their
        # delays re-draw per plan).  repair="legacy" keeps the
        # pre-generalization gate — om_alg plus singleton spread-mode G-DM
        # — for before/after hit-rate comparisons.
        gdm_names = ("gdm",) if self.repair == "legacy" else ("gdm", "gdm_rt")
        grouped = name in gdm_names and spread
        if not (name == "om_alg" or grouped):
            return None
        ep = self._epoch
        if ep is None or ep.plan is None or not self._arrived_since_plan:
            return None
        new_jids = {j.jid for j in self._arrived_since_plan}
        old_keys = [(jid, orig) for jid in cid_maps if jid not in new_jids
                    for orig in cid_maps[jid]]
        if not old_keys:
            return None   # nothing retained: a plain (cheap) replan
        parts = ep.plan.schedule.parts \
            if isinstance(ep.plan.schedule, CompositeSchedule) else None
        if not parts:
            return None   # no retained expansion (transcript-only scheduler)

        def reject():
            self.stats.repair_rejects += 1
            return None

        if grouped:
            return self._repair_grouped(sub, cid_maps, parts, new_jids, ep,
                                        name, opts, reject, pinned)

        # (1) every unfinished retained coflow untouched since the plan
        for key in old_keys:
            base = ep.base_remaining.get(key)
            if base is None or not np.array_equal(self._remaining[key], base):
                return reject()

        # (2) Algorithm 5 keeps retained jobs in planned order, new at tail
        from .ordering import cached_job_order

        order = cached_job_order(sub, plan_backend=self.plan_backend,
                                 device=self.device).order
        old_order = [jid for jid in ep.plan.schedule.meta.get("order", ())
                     if jid in cid_maps and jid not in new_jids]
        n_old = len(old_order)
        if order[:n_old] != old_order or set(order[n_old:]) != new_jids:
            return reject()

        # (3) retained ledger windows == the windows a from-scratch om_alg
        # replan would emit: back-to-back effective-size windows per coflow
        # in topological order, starting at the arrival cut
        tau = self._t - ep.t0
        win: dict[tuple[int, int], tuple[int, object]] = {}
        for pi, part in enumerate(parts):   # one entry per coflow, across parts
            for e in part.ledger:
                win[(e.jid, e.cid)] = (pi, e)
        by_jid = {j.jid: j for j in sub.jobs}
        old_cid = {jid: {orig: k for k, orig in enumerate(ep.cid_maps[jid])}
                   for jid in ep.cid_maps}
        keep: list[set[tuple[int, int]]] = [set() for _ in parts]
        remap: dict[tuple[int, int], int] = {}
        cursor = 0.0
        for jid in order[:n_old]:
            job = by_jid[jid]
            for cid_sub in topological_order(job.mu, job.edges):
                orig = cid_maps[jid][cid_sub]
                oc = old_cid[jid].get(orig)
                hit = win.get((jid, oc)) if oc is not None else None
                if hit is None:
                    return reject()
                pi, e = hit
                D = effective_size(self._remaining[(jid, orig)])
                if abs(e.e0 - tau - cursor) > 1e-6 or \
                        abs(e.e1 - tau - (cursor + D)) > 1e-6:
                    return reject()
                keep[pi].add((jid, oc))
                remap[(jid, oc)] = cid_sub
                cursor += D

        # splice: retained expansion suffix (compacted into one part, so
        # chained repairs stay O(1) parts) + new jobs planned in isolation
        from .dma import isolated_job_unit
        from .engine import PlanResult
        from .timeline import FinalSchedule, merge_and_fix

        try:
            suffixes = [part.spliced(tau, keep[pi], remap)
                        for pi, part in enumerate(parts) if keep[pi]]
            new_parts = suffixes if len(suffixes) <= 1 else \
                [FinalSchedule.concat_expansion_free(suffixes, self.m)]
        except ValueError:
            return reject()
        t_new = int(round(cursor))
        units = []
        from . import backend

        backend.prefetch_plan((c.demand for jid in order[n_old:]
                               for c in by_jid[jid].coflows),
                              plan_backend=self.plan_backend,
                              device=self.device)
        for jid in order[n_old:]:
            job = by_jid[jid]
            units.append(isolated_job_unit(job, start=t_new,
                                           device=self.device,
                                           plan_backend=self.plan_backend))
            t_new += sum(c.D for c in job.coflows)
        if units:
            new_parts.append(merge_and_fix(units, self.m, origin=0,
                                           device=self.device,
                                           plan_backend=self.plan_backend))
        sched = CompositeSchedule(new_parts, sub, meta={
            "order": list(order),
            "algorithm": ep.plan.schedule.meta.get("algorithm", "O(m)Alg"),
            "repaired": True})
        plan = PlanResult(ep.plan.name, sched)
        self._last_plan = plan
        return self._make_epoch(plan.transcript(), plan, cid_maps, sub)

    def _repair_grouped(self, sub: Instance, cid_maps: dict[int, list[int]],
                        parts, new_jids: set, ep: _Epoch, name: str,
                        opts: dict, reject, pinned=None):
        """Group-aware repair for spread-mode G-DM / G-DM-RT (module
        docstring): re-derive the Algorithm 5 order and geometric grouping
        of the residual instance (under the session's pinned gamma when
        one is active — the same value the full replan would use), then
        walk the replan's group chain — sliding each retained group part
        whose inputs are untouched to its new chain position as one block,
        and rebuilding the rest through the backend's group-block cache.
        Bit-identical to the full replan by construction: spread-mode
        DMA/DMA-SRT layouts are deterministic functions of (group jobs,
        residual demands, origin), and translation invariant in the
        origin — so a block built at any origin is exact at any other."""
        from .engine import PlanResult
        from .gdm import group_jobs
        from .ordering import cached_job_order

        old_groups = ep.plan.schedule.meta.get("groups")
        if old_groups is None or len(old_groups) != len(parts):
            return reject()
        legacy = self.repair == "legacy"
        tau = self._t - ep.t0
        itau = int(round(tau))
        if legacy and abs(tau - itau) > 1e-6:
            return reject()   # legacy's aligned reuse needs the packet clock
        order = cached_job_order(sub, plan_backend=self.plan_backend,
                                 device=self.device).order
        groups = group_jobs(sub, order, gamma=pinned)
        if legacy and any(len(g) != 1 for g in groups):
            return reject()
        old_idx = {tuple(g): i for i, g in enumerate(old_groups)}
        by_jid = {j.jid: j for j in sub.jobs}

        def untouched(g) -> bool:
            """Same member coflows as at plan time, residuals bit-equal."""
            for jid in g:
                if ep.cid_maps.get(jid) != cid_maps.get(jid):
                    return False
                for orig in cid_maps[jid]:
                    base = ep.base_remaining.get((jid, orig))
                    if base is None or \
                            not np.array_equal(self._remaining[(jid, orig)],
                                               base):
                        return False
            return True

        static = []   # per group: the old part to reuse, or None
        for g in groups:
            i = old_idx.get(tuple(g))
            ok = i is not None and not (set(g) & new_jids) and untouched(g)
            static.append(parts[i] if ok else None)
        if not any(p is not None for p in static):
            return None   # nothing reusable: the replan does the same work
        if legacy and not all(p is not None for p in static):
            return reject()   # legacy path required the whole plan retained

        from . import backend

        backend.prefetch_plan(
            (c.demand for g, p in zip(groups, static) if p is None
             for jid in g for c in by_jid[jid].coflows),
            plan_backend=self.plan_backend, device=self.device)

        beta = float(opts.get("beta", 2.0))
        decompose = bool(opts.get("decompose", False))
        nested = bool(opts.get("nested", True))
        require_tree = bool(opts.get("require_tree", True))

        new_parts = []
        reused = 0
        cursor = 0
        for g, old_part in zip(groups, static):
            # gdm(): start = max(t_cur, releases) — sub releases are all 0
            if old_part is not None and \
                    (not legacy or old_part.origin == itau + cursor):
                # the replan would rebuild this group from the same inputs:
                # slide the whole retained block to its new chain position
                # (legacy only reuses at the exact aligned position)
                part = old_part.shifted_expanded(cursor - int(old_part.origin))
                reused += 1
            else:
                jobs_g = [by_jid[jid] for jid in g]
                part = backend.group_block(
                    name, jobs_g, self.m, beta=beta, decompose=decompose,
                    nested=nested, require_tree=require_tree,
                    delays="spread", device=self.device,
                    plan_backend=self.plan_backend).shifted_expanded(cursor)
                # the cached block may have been built by another plan, on
                # another device or plan backend: re-home it onto this one,
                # so its lazy fix-up runs where this plan runs
                part = dataclasses.replace(part, device=self.device,
                                           plan_backend=self.plan_backend)
            new_parts.append(part)
            cursor = int(math.ceil(part.makespan))
        if reused == 0:
            return None   # chain never aligned; the work done == a replan's
        self.stats.groups_reused += reused
        self.stats.groups_replanned += len(groups) - reused
        sched = CompositeSchedule(new_parts, sub, meta={
            "order": list(order),
            "groups": [list(g) for g in groups],
            "algorithm": ep.plan.schedule.meta.get(
                "algorithm", "G-DM-RT" if name == "gdm_rt" else "G-DM"),
            "beta": beta,
            "repaired": True})
        plan = PlanResult(ep.plan.name, sched)
        self._last_plan = plan
        return self._make_epoch(plan.transcript(), plan, cid_maps, sub)

"""Sustained-arrivals streaming driver (serving-rate framing of §VII-C.2)
— the port of ``repro.core.stream``.

``simulate_online`` measures *what* schedule quality the rescheduling
protocol achieves; this module measures whether a live
:class:`~repro_torch.core.session.SchedulerSession` can *keep up* when jobs
arrive continuously at a calibrated load.  The pieces:

- :func:`arrival_times` — seeded Poisson or bursty two-state MMPP
  (Markov-modulated Poisson) release times, floored to the integer
  wall-clock grid exactly like ``traces.poisson_releases``.
- :func:`stream_jobs` — a heavy-tail workload built from the trace
  primitives (``sample_coflows`` widths/sizes, ``dag_edges`` precedence),
  with the arrival rate calibrated so `load` is the fraction of the
  busiest port's sustainable service rate (load 1.0 = the port-bottleneck
  lower bound on the trace makespan equals the arrival horizon).
- :class:`StreamDriver` — feeds arrivals one by one into a live session,
  timing each arrival's submit+replan wall clock (the *scheduling
  latency* a serving system quotes at p50/p95/p99).  With an
  :class:`~repro_torch.core.session.AdmissionPolicy` attached it applies
  backpressure: while the session's windowed replan debt exceeds the
  policy budget, new arrivals are *deferred* to the next planned
  completion boundary (a clean cut of the sequential plan, where
  frontier-append repair is likely), and once the deferral queue exceeds
  ``max_pending`` they are *rejected* outright.  Deferral/reject counts
  surface in ``SessionStats``.

Without a policy the driver is pure: every arrival is submitted at its
release time, so completions and TWCT are bit-identical to
``simulate_online(..., driver="batch")`` on the same trace — the extra
per-arrival replans execute zero time before the next event and the
repair path is certified results-identical.  Backpressure deliberately
trades schedule optimality for replan-rate stability, so policy runs are
*not* batch-identical.

The driver's session plans on ``device`` (default ``"cuda"``) through
``plan_backend``; the per-arrival latency is the host clock around submit
and replan, which ends in host data (the frontier), so it includes the
device work of the replan.
"""
from __future__ import annotations

import dataclasses
import time
from bisect import insort
from dataclasses import dataclass

import numpy as np
import torch

from .session import AdmissionPolicy, SchedulerSession
from .traces import dag_edges, sample_coflows
from .types import Coflow, Job

__all__ = [
    "arrival_times",
    "stream_jobs",
    "StreamDriver",
    "StreamResult",
    "run_stream",
]

_EPS = 1e-9


# --- arrival processes ------------------------------------------------------

def arrival_times(
    n: int,
    rate: float,
    seed: int = 0,
    *,
    process: str = "poisson",
    burst: float = 8.0,
    p_enter_burst: float = 0.05,
    p_exit_burst: float = 0.25,
) -> np.ndarray:
    """`n` integer release times with mean arrival rate `rate`.

    process="poisson": i.i.d. exponential gaps (the paper's §VII-B.2
    arrival model).  process="mmpp": a two-state Markov-modulated Poisson
    process — a background state and a burst state whose rate is `burst`x
    the background rate, switching per-gap with the given probabilities;
    the two rates are solved so the *stationary* mean rate is `rate`, so
    poisson and mmpp traces carry the same long-run load and differ only
    in burstiness.  Gaps are cumulative-summed and floored to int64,
    matching ``traces.poisson_releases``.
    """
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    if process not in ("poisson", "mmpp"):
        raise ValueError(f"unknown arrival process {process!r}; "
                         f"choose from ('poisson', 'mmpp')")
    rng = np.random.default_rng(seed + 2)
    if process == "poisson":
        gaps = rng.exponential(1.0 / rate, size=n)
    else:
        if burst <= 1.0:
            raise ValueError(f"burst ratio must be > 1, got {burst}")
        # stationary state shares: pi_bg = p_exit / (p_enter + p_exit)
        pi_bg = p_exit_burst / (p_enter_burst + p_exit_burst)
        pi_bu = 1.0 - pi_bg
        # mean gap = pi_bg / r_bg + pi_bu / (burst * r_bg) == 1 / rate
        r_bg = rate * (pi_bg + pi_bu / burst)
        r_bu = burst * r_bg
        gaps = np.empty(n, dtype=np.float64)
        in_burst = rng.random() < pi_bu       # start at stationarity
        for i in range(n):
            gaps[i] = rng.exponential(1.0 / (r_bu if in_burst else r_bg))
            p_flip = p_exit_burst if in_burst else p_enter_burst
            if rng.random() < p_flip:
                in_burst = not in_burst
    cum = np.cumsum(gaps)
    if cum.size and cum[-1] >= 2.0**53:
        # float64 stops representing integers exactly at 2^53, so the
        # floor below would no longer be the true integer release time
        raise ValueError(
            f"cumulative arrival time {cum[-1]:.3g} exceeds the float64 "
            "integer-exact range (2^53); lower n or raise rate")
    return np.floor(cum).astype(np.int64)


# --- workload builder -------------------------------------------------------

def stream_jobs(
    m: int,
    n_jobs: int,
    seed: int = 0,
    *,
    process: str = "poisson",
    load: float = 0.7,
    mu: int = 3,
    dag: str = "tree",
    width_dist: tuple = ("loguniform", 2, 12),
    size_dist: tuple = ("pareto", 1.5, 8.0),
    size_clip: tuple[int, int] = (1, 4096),
    burst: float = 8.0,
) -> list[Job]:
    """A sustained-arrivals trace: `n_jobs` jobs of `mu` heavy-tail coflows
    each (Pareto sizes by default) with `dag`-family precedence, released
    by the chosen arrival process at a rate calibrated to `load`.

    Calibration: the busiest port must move ``max_port_work`` units over
    the whole trace, so the trace cannot drain faster than that; the
    arrival horizon is stretched to ``max_port_work / load``, i.e.
    ``rate = load * n_jobs / max_port_work``.  load < 1 is sustainable,
    load > 1 provably overloads the interconnect (the backpressure
    regime).  Returns jobs sorted by release.
    """
    if n_jobs < 1:
        raise ValueError(f"n_jobs must be >= 1, got {n_jobs}")
    if load <= 0:
        raise ValueError(f"load must be positive, got {load}")
    if mu < 1:
        raise ValueError(f"mu must be >= 1, got {mu}")
    demands = sample_coflows(m, n_jobs * mu, seed, width_dist=width_dist,
                             size_dist=size_dist, size_clip=size_clip)
    rng = np.random.default_rng(seed + 1)
    jobs: list[Job] = []
    for jid in range(n_jobs):
        group = demands[jid * mu:(jid + 1) * mu]
        coflows = [Coflow(jid, k, d) for k, d in enumerate(group)]
        edges = dag_edges(len(coflows), dag, rng)
        jobs.append(Job(jid, coflows, edges, weight=1.0, release=0))

    total = np.zeros((m, m), dtype=np.int64)
    for d in demands:
        total += d
    max_port_work = int(max(total.sum(axis=1).max(), total.sum(axis=0).max()))
    rate = load * n_jobs / max(max_port_work, 1)
    times = arrival_times(n_jobs, rate, seed, process=process, burst=burst)

    released = [dataclasses.replace(j, release=int(t))
                for j, t in zip(jobs, times)]
    released.sort(key=lambda j: (j.release, j.jid))
    return released


# --- streaming driver -------------------------------------------------------

@dataclass
class StreamResult:
    """Serving-rate view of a drained stream: the OnlineResult plus the
    per-arrival scheduling latencies and admission outcome counts."""
    online: object                      # OnlineResult (avoids import cycle)
    latencies_s: np.ndarray             # one entry per *submitted* arrival
    offered: int
    admitted: int
    deferred: int
    rejected: tuple[int, ...]           # jids turned away (never submitted)
    wall_s: float                       # feed + drain wall clock

    def latency_ms(self, q: float) -> float:
        if self.latencies_s.size == 0:
            return 0.0
        return float(np.percentile(self.latencies_s, q) * 1e3)

    @property
    def p50_ms(self) -> float:
        return self.latency_ms(50)

    @property
    def p95_ms(self) -> float:
        return self.latency_ms(95)

    @property
    def p99_ms(self) -> float:
        return self.latency_ms(99)

    @property
    def jobs_per_sec(self) -> float:
        """Sustained service rate: admitted jobs per wall-clock second of
        driving the stream (submit + replan + execute bookkeeping)."""
        return self.admitted / self.wall_s if self.wall_s > 0 else 0.0

    def as_dict(self) -> dict:
        d = {
            "p50_ms": self.p50_ms,
            "p95_ms": self.p95_ms,
            "p99_ms": self.p99_ms,
            "jobs_per_sec": self.jobs_per_sec,
            "offered": self.offered,
            "admitted": self.admitted,
            "deferred": self.deferred,
            "rejected": len(self.rejected),
            "twct": self.online.twct(),
            "wall_s": self.wall_s,
        }
        d.update({f"session_{k}": v
                  for k, v in self.online.stats["session"].items()})
        return d


class StreamDriver:
    """Feed a sustained arrival trace through a live SchedulerSession.

    ``feed(job)`` advances the session to the job's release and returns
    "submitted", "deferred", or "rejected"; ``drain()`` flushes the
    deferral queue and runs the session dry; ``result()`` wraps it all in
    a :class:`StreamResult`.  Jobs must be fed in release order.
    """

    def __init__(self, m: int, scheduler="gdm", *,
                 repair: "bool | str" = True,
                 admission: AdmissionPolicy | None = None,
                 gamma: "str | int | object" = "residual",
                 device: "str | torch.device" = "cuda",
                 plan_backend: "str | None" = None, **opts):
        self.session = SchedulerSession(m, scheduler, repair=repair,
                                        admission=admission, gamma=gamma,
                                        device=device,
                                        plan_backend=plan_backend, **opts)
        self.admission = admission
        self._deferred: list[tuple[float, int, Job]] = []   # (due, jid, job)
        self._latencies: list[float] = []
        self._offered = 0
        self._rejected: list[int] = []
        self._deferred_total = 0
        self._wall = 0.0
        self._drained = False

    # -- event API -----------------------------------------------------------

    def feed(self, job: Job) -> str:
        t0 = time.perf_counter()
        try:
            return self._feed(job)
        finally:
            self._wall += time.perf_counter() - t0

    def drain(self) -> None:
        t0 = time.perf_counter()
        try:
            while self._deferred:
                due, _, job = self._deferred.pop(0)
                if due > self.session.now + _EPS:
                    self.session.advance(until=due)
                self._submit_timed(job)
            self.session.advance()
            self._drained = True
        finally:
            self._wall += time.perf_counter() - t0

    def result(self) -> StreamResult:
        if not self._drained:
            self.drain()
        online = self.session.result()
        return StreamResult(
            online=online,
            latencies_s=np.asarray(self._latencies, dtype=np.float64),
            offered=self._offered,
            admitted=len(self._latencies),
            deferred=self._deferred_total,
            rejected=tuple(self._rejected),
            wall_s=self._wall,
        )

    # -- internals -----------------------------------------------------------

    def _feed(self, job: Job) -> str:
        self._offered += 1
        release = float(job.release)
        self._flush_deferred(release)
        if release > self.session.now + _EPS:
            self.session.advance(until=release)
        if self.admission is not None and self.session.backpressure():
            if len(self._deferred) >= self.admission.max_pending:
                self._rejected.append(job.jid)
                self.session.stats.admission_rejects += 1
                return "rejected"
            insort(self._deferred, (self._next_boundary(), job.jid, job))
            self._deferred_total += 1
            self.session.stats.admission_deferred += 1
            return "deferred"
        self._submit_timed(job)
        return "submitted"

    def _submit_timed(self, job: Job) -> None:
        """Submit and immediately replan — the arrival's scheduling latency
        as a serving system would quote it."""
        t0 = time.perf_counter()
        self.session.submit(job)
        self.session.frontier()
        self._latencies.append(time.perf_counter() - t0)

    def _flush_deferred(self, upto: float) -> None:
        while self._deferred and self._deferred[0][0] <= upto + _EPS:
            due, _, job = self._deferred.pop(0)
            if due > self.session.now + _EPS:
                self.session.advance(until=due)
            self._submit_timed(job)

    def _next_boundary(self) -> float:
        """The next planned completion after `now` — a clean cut of the
        sequential plan where a deferred arrival lands as a frontier
        append (repair-friendly).  Falls back to `now` when the plan has
        no future completions."""
        fr = self.session.frontier()
        future = [c for c in fr.completions.values()
                  if c > self.session.now + _EPS]
        return min(future) if future else self.session.now


def run_stream(jobs: list[Job], m: int, scheduler="gdm", *,
               repair: "bool | str" = True,
               admission: AdmissionPolicy | None = None,
               gamma: "str | int | object" = "residual",
               device: "str | torch.device" = "cuda",
               plan_backend: "str | None" = None,
               **opts) -> StreamResult:
    """Feed `jobs` (sorted by release) through a fresh StreamDriver and
    drain it.  Without `admission` the completions/twct are bit-identical
    to ``simulate_online(Instance(m, jobs), scheduler, driver="batch")``
    — including under a pinned grouping scale (``gamma="pinned"``, see
    core/session.py), which both drivers derive identically from the
    residual sequence.  Every replan runs on ``device`` through
    ``plan_backend``."""
    drv = StreamDriver(m, scheduler, repair=repair, admission=admission,
                       gamma=gamma, device=device, plan_backend=plan_backend,
                       **opts)
    for j in sorted(jobs, key=lambda j: (j.release, j.jid)):
        drv.feed(j)
    drv.drain()
    return drv.result()

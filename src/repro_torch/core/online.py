"""Online scenario driver (paper §VII-B.2 / §VII-C.2) — the port of
``repro.core.online``.

Jobs arrive over time (Poisson in the paper's experiments). On every
arrival, the scheduler suspends the active plan, updates remaining demands,
and reschedules everything currently in the system — exactly the paper's
protocol. Completion times are measured from each job's arrival.

``simulate_online`` is a thin convenience driver over the stateful
:class:`~repro_torch.core.session.SchedulerSession` (which owns the
residual-demand ledger and the cumulative-flooring executor): submit every
job, let ``advance()`` drain the event loop, return the session's result.
The historical closed batch loop is retained behind ``driver="batch"`` as
the reference comparator — the two are results-identical on every
scenario x scheduler cell, bit for bit.

`scheduler` may be a plain callable, a prebuilt engine scheduler
(``make_scheduler``), or a registered scheduler name (see core/engine.py);
engine.plan_online is the stats-reporting incremental wrapper around this
driver.  Both drivers plan on ``device`` through ``plan_backend``, as the
session does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..kernels import resolve_device
from .result import Transcript
from .session import SchedulerSession, execute_transcript, sub_instance
from .types import Instance, Job

__all__ = ["simulate_online", "OnlineResult"]

SchedulerFn = Callable[[Instance], Transcript]


@dataclass
class OnlineResult:
    job_completions: dict[int, float]     # absolute wall-clock completion
    instance: Instance
    reschedules: int
    stats: dict = field(default_factory=dict)  # cache/session/wall stats

    def twct(self) -> float:
        """Sum of weighted response times (measured from arrival)."""
        total = 0.0
        for j in self.instance.jobs:
            total += j.weight * (self.job_completions[j.jid] - j.release)
        return total

    @property
    def makespan(self) -> float:
        return max(self.job_completions.values(), default=0.0)


def _resolve_scheduler(scheduler, opts: dict, device,
                       plan_backend) -> SchedulerFn:
    if isinstance(scheduler, str):
        from .engine import make_scheduler

        return make_scheduler(scheduler, device=device,
                              plan_backend=plan_backend, **opts).plan
    if opts:
        raise TypeError("scheduler options are only accepted with a "
                        "scheduler name, not a prebuilt scheduler")
    plan = getattr(scheduler, "plan", None)
    if callable(plan) and not isinstance(scheduler, type):
        return plan
    return scheduler


def simulate_online(instance: Instance, scheduler, driver: str = "session",
                    repair: bool = True, gamma="residual",
                    device: "str | torch.device" = "cuda",
                    plan_backend: "str | None" = None,
                    **opts) -> OnlineResult:
    """Run the rescheduling protocol.  `scheduler` may be a callable, an
    engine Scheduler, or a registered name; with a name, **opts are bound
    through the registry (e.g. ``simulate_online(inst, "gdm_bf",
    exec="ledger")`` selects the backfill executor for every replan).

    driver="session" (default) drives a SchedulerSession (frontier-append
    plan repair enabled unless ``repair=False``); driver="batch" runs the
    historical closed batch loop — the results-identical reference.

    ``gamma`` is the grouping-scale policy ('residual' | 'pinned' |
    positive number — see core/session.py); both drivers implement the
    identical pinned-gamma epoch, so the bit-identity contract holds
    under pinning too.  ``device`` (``cuda`` without a card raises) and
    ``plan_backend`` are where and how every replan runs."""
    if driver not in ("session", "batch"):
        raise ValueError(f"unknown driver {driver!r}; "
                         f"choose from ('session', 'batch')")
    if driver == "batch":
        return _simulate_online_batch(instance, scheduler, gamma=gamma,
                                      device=device,
                                      plan_backend=plan_backend, **opts)
    session = SchedulerSession(instance.m, scheduler, repair=repair,
                               gamma=gamma, device=device,
                               plan_backend=plan_backend, **opts)
    for j in sorted(instance.jobs, key=lambda j: (j.release, j.jid)):
        session.submit(j)
    session.advance()
    res = session.result()
    res.instance = instance
    return res


def _simulate_online_batch(instance: Instance, scheduler, gamma="residual",
                           device: "str | torch.device" = "cuda",
                           plan_backend: "str | None" = None,
                           **opts) -> OnlineResult:
    """The historical closed batch loop (reference comparator).

    Mirrors the session's pinned-gamma epoch exactly: the pin is a pure
    function of the residual-instance sequence (one ``observe`` per
    replan), so session and batch plan every residual with the same
    gamma — the bit-identity contract survives pinning."""
    from .gdm import GammaEpoch

    epoch = GammaEpoch.from_policy(gamma)
    device = resolve_device(device)
    if epoch is None:
        scheduler = _resolve_scheduler(scheduler, opts, device, plan_backend)
    else:
        from .engine import make_scheduler, scheduler_options

        name = scheduler if isinstance(scheduler, str) \
            else getattr(scheduler, "name", None)
        try:
            gamma_ok = isinstance(name, str) and \
                "gamma" in scheduler_options(name)
        except KeyError:
            gamma_ok = False
        if not gamma_ok:
            raise ValueError(
                f"gamma={gamma!r} needs an engine scheduler taking the "
                f"'gamma' plan option (the G-DM family); got {name!r}")
        if isinstance(scheduler, str):
            sched_obj = make_scheduler(scheduler, device=device,
                                       plan_backend=plan_backend, **opts)
        elif opts:
            raise TypeError("scheduler options are only accepted with a "
                            "scheduler name, not a prebuilt scheduler")
        else:
            sched_obj = scheduler

        def scheduler(sub):
            return sched_obj.plan_full(
                sub, gamma=epoch.observe(sub.gamma())).transcript()
    jobs = sorted(instance.jobs, key=lambda j: (j.release, j.jid))
    remaining: dict[tuple[int, int], np.ndarray] = {
        (j.jid, c.cid): c.demand.astype(np.int64).copy()
        for j in jobs for c in j.coflows
    }
    done: dict[tuple[int, int], float] = {}
    for j in jobs:  # coflows that are empty from the start
        for c in j.coflows:
            if remaining[(j.jid, c.cid)].sum() == 0:
                done[(j.jid, c.cid)] = float(j.release)

    arrivals = [float(j.release) for j in jobs]
    i = 0
    t = arrivals[0] if arrivals else 0.0
    active: list[Job] = []
    reschedules = 0

    while i < len(jobs) or any(
        remaining[(j.jid, c.cid)].sum() > 0 for j in active for c in j.coflows
    ):
        while i < len(jobs) and arrivals[i] <= t + 1e-9:
            active.append(jobs[i])
            i += 1
        sub, cid_maps = sub_instance(active, remaining, done, instance.m)
        if not sub.jobs:
            if i < len(jobs):
                t = arrivals[i]
                continue
            break
        transcript = scheduler(sub)
        reschedules += 1
        t_next = arrivals[i] if i < len(jobs) else math.inf
        horizon = t_next - t
        execute_transcript(transcript, horizon, t, cid_maps, remaining, done)
        t = t_next if i < len(jobs) else t

    job_comp: dict[int, float] = {}
    for j in instance.jobs:
        cs = [done[(j.jid, c.cid)] for c in j.coflows]
        job_comp[j.jid] = max(cs, default=float(j.release))
    return OnlineResult(job_comp, instance, reschedules)

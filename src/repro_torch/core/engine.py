"""Scheduler engine: one registry, one plan() entry point — the port of
``repro.core.engine``.

Registered schedulers and their paper algorithms (Shafiee & Ghaderi 2020):

========== ==============================================================
key        paper construction
========== ==============================================================
gdm        G-DM (Algorithm 4, §VI): primal-dual order (Algorithm 5) +
           geometric grouping + DMA (Algorithm 2) per group
gdm_rt     G-DM-RT (Algorithm 4 over rooted trees): groups scheduled by
           DMA-RT (Algorithm 3 / §V-B); ``nested=False`` selects the flat
           fast path (single global merge-and-fix)
om_alg     O(m)Alg baseline (Tian et al. [5]): one-at-a-time jobs in
           Algorithm 5 order, each coflow optimally via BNA (Algorithm 1)
gdm_bf     G-DM + backfilling (§VII)
gdm_rt_bf  G-DM-RT + backfilling (§VII)
om_alg_bf  O(m)Alg + backfilling (§VII)
========== ==============================================================

The ``*_bf`` variants accept ``exec="packet"`` (default: matching-granular
re-execution of the plan's timed-matching decomposition, pointwise never
worse than the plan) or ``exec="ledger"`` (the historical uniform-rate
ledger sweep) — see ``backfill.py``.  The packet executor's decomposition
(the fix-up BNA of every merged interval) runs on the plan's device and
plan backend.

Every plan runs on a device and a plan backend:
``plan(instance, name, device="cuda", plan_backend=None)``.

* ``plan_backend="pipeline"`` (the default on a card, the reference's
  ``jit``) decomposes each width bucket of coflows, step and repair, in
  one ``bna_decompose`` call, and runs every merge_and_fix through the
  fused ``merge_fix``;
* ``plan_backend="python"`` (the default on the CPU) decomposes through
  ``bna_step`` with the repair on the host, and computes the alphas
  through ``coflow_merge``.

``device="cpu"`` runs the kernels' plain PyTorch versions.  Every
combination gives the same plan, bit for bit.  Asking for ``cuda``
without a card raises.

The online protocol (§VII-C.2) runs through :func:`plan_online`, a
driver over ``core/session.py``'s ``SchedulerSession`` that replans every
arrival's residual instance on the same device and plan backend; the
session threads its pinned gamma through ``plan_full(instance, gamma=)``.

Adding a scheduler is one decorator::

    @register_scheduler("my_sched", "one-line description",
                        options=("seed",))
    def _my_sched(instance, *, device, plan_backend, seed=0):
        return ...  # CompositeSchedule or BackfillResult
"""
from __future__ import annotations

import inspect
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..kernels import resolve_device
from . import backend
from .backfill import BackfillResult, backfill
from .baseline import om_alg
from .gdm import gdm
from .result import CompositeSchedule, Transcript
from .types import Instance

__all__ = [
    "PlanResult",
    "register_scheduler",
    "make_scheduler",
    "available_schedulers",
    "scheduler_options",
    "plan",
    "plan_online",
]


@dataclass
class PlanResult:
    """A planned schedule plus uniform metric access.

    `schedule` is the scheduler's native result — a CompositeSchedule for
    the plain algorithms, a BackfillResult for the backfilled variants —
    with the metric/transcript accessors normalized here.
    """

    name: str
    schedule: CompositeSchedule | BackfillResult

    def transcript(self) -> Transcript:
        s = self.schedule
        return s.transcript() if callable(s.transcript) else s.transcript

    def job_completions(self) -> dict[int, float]:
        s = self.schedule
        return dict(s.job_completions) if isinstance(s, BackfillResult) \
            else s.job_completions()

    def twct(self, from_release: bool = False) -> float:
        return self.schedule.twct(from_release)

    @property
    def makespan(self) -> float:
        return float(self.schedule.makespan)

    def backfilled(self, exec: str = "packet") -> "PlanResult":
        """Backfill this plan (§VII) without re-planning, on the plan's own
        device and plan backend.

        exec="packet" (default) re-executes the timed-matching decomposition
        (pointwise never worse than the plan); exec="ledger" re-executes the
        uniform-rate ledger (the historical executor)."""
        if isinstance(self.schedule, BackfillResult):
            if self.schedule.executor != exec:
                raise ValueError(
                    f"already backfilled with exec={self.schedule.executor!r}; "
                    f"a BackfillResult cannot be re-executed as {exec!r} — "
                    f"plan the base scheduler and call backfill(..., exec=...)")
            return self
        return PlanResult(f"{self.name}_bf", backfill(self.schedule, exec=exec))


_Factory = Callable[..., "CompositeSchedule | BackfillResult"]


@dataclass
class _Entry:
    factory: _Factory
    doc: str
    options: tuple[str, ...]


_REGISTRY: dict[str, _Entry] = {}


def register_scheduler(name: str, doc: str = "",
                       options: tuple[str, ...] = ()):
    """Register `factory(instance, *, device, plan_backend, **opts)` under
    `name` (decorator).

    ``options`` declares the option names the factory accepts;
    :func:`make_scheduler` rejects anything else.  The declared tuple is
    checked against the factory's signature at registration: every
    keyword-only parameter but ``device`` and ``plan_backend`` must be
    declared, and — unless the factory forwards ``**opts`` — every
    declared option must be a real parameter."""

    def deco(factory: _Factory) -> _Factory:
        if name in _REGISTRY:
            raise ValueError(f"scheduler {name!r} already registered")
        params = inspect.signature(factory).parameters.values()
        kw = {p.name for p in params if p.kind == p.KEYWORD_ONLY}
        has_var = any(p.kind == p.VAR_KEYWORD for p in params)
        for arg in ("device", "plan_backend"):
            if arg not in kw:
                raise ValueError(f"scheduler {name!r}: the factory must "
                                 f"take a keyword-only {arg!r}")
            kw.discard(arg)
        declared = set(options)
        if kw - declared or (not has_var and declared - kw):
            raise ValueError(f"scheduler {name!r}: declared options "
                             f"{sorted(declared)} differ from the factory's "
                             f"keywords {sorted(kw)}")
        _REGISTRY[name] = _Entry(
            factory, doc or (factory.__doc__ or "").strip(), tuple(options))
        return factory

    return deco


def available_schedulers() -> dict[str, str]:
    """name -> one-line description, for CLIs and reports."""
    return {name: e.doc for name, e in sorted(_REGISTRY.items())}


def scheduler_options(name: str) -> tuple[str, ...]:
    """The option names scheduler `name` accepts."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown scheduler {name!r}; "
                       f"registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name].options


@dataclass
class _Registered:
    """A registry entry bound to its options, device and plan backend."""

    name: str
    device: torch.device
    plan_backend: str
    opts: dict = field(default_factory=dict)

    def plan_full(self, instance: Instance, **overrides) -> PlanResult:
        # instance-level prefetch: one batched decomposition on the device
        # (the pipeline's bucket sweep, or bna_many) warms the caches for
        # every coflow BEFORE the factory walks the jobs one at a time
        # (results-identical either way).  `overrides` are per-plan option
        # overrides validated against the registry exactly like
        # make_scheduler's — the session threads its pinned gamma through
        # here, one value per planning event.
        opts = self.opts
        if overrides:
            unknown = sorted(set(overrides)
                             - set(_REGISTRY[self.name].options))
            if unknown:
                raise TypeError(
                    f"unknown plan override(s) {unknown} for scheduler "
                    f"{self.name!r}; valid options: "
                    f"{sorted(_REGISTRY[self.name].options)}")
            opts = {**self.opts, **overrides}
        backend.prefetch_plan((c.demand for j in instance.jobs
                               for c in j.coflows),
                              plan_backend=self.plan_backend,
                              device=self.device)
        return PlanResult(self.name, _REGISTRY[self.name].factory(
            instance, device=self.device, plan_backend=self.plan_backend,
            **opts))

    def plan(self, instance: Instance) -> Transcript:
        return self.plan_full(instance).transcript()


def make_scheduler(name: str, device: "str | torch.device" = "cuda",
                   plan_backend: "str | None" = None,
                   **opts) -> _Registered:
    """Instantiate a registered scheduler with bound options on `device`
    and `plan_backend` (``"python"`` or ``"pipeline"``; None takes the
    device's default, ``"pipeline"`` on a card and ``"python"`` on the
    CPU).  An unknown option or plan backend raises immediately; ``cuda``
    without a card raises."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown scheduler {name!r}; "
                       f"registered: {sorted(_REGISTRY)}")
    unknown = sorted(set(opts) - set(_REGISTRY[name].options))
    if unknown:
        raise TypeError(
            f"unknown option(s) {unknown} for scheduler {name!r}; "
            f"valid options: {sorted(_REGISTRY[name].options)}")
    dev = resolve_device(device)
    return _Registered(name, dev, backend.resolve_plan_backend(plan_backend,
                                                               dev), opts)


def plan(instance: Instance, name: str,
         device: "str | torch.device" = "cuda",
         plan_backend: "str | None" = None, **opts) -> PlanResult:
    """One-shot: plan `instance` with scheduler `name` on `device` through
    `plan_backend` (see :func:`make_scheduler`)."""
    return make_scheduler(name, device=device, plan_backend=plan_backend,
                          **opts).plan_full(instance)


# --------------------------------------------------------------------------
# registered schedulers
# --------------------------------------------------------------------------

def _rng(opts_rng, seed):
    return np.random.default_rng(seed) if opts_rng is None else opts_rng


_GDM_OPTS = ("beta", "seed", "rng", "nested", "decompose", "delays", "gamma")
_GDM_RT_OPTS = _GDM_OPTS + ("require_tree",)
_OM_ALG_OPTS = ("decompose", "seed")


@register_scheduler("gdm", "G-DM (Algorithm 4): primal-dual order + "
                           "geometric groups + DMA per group; "
                           "delays=random|spread",
                    options=_GDM_OPTS)
def _gdm(instance: Instance, *, device, plan_backend, beta: float = 2.0,
         seed: int = 0,
         rng=None, nested: bool = True, decompose: bool = False,
         delays: str = "random", gamma=None) -> CompositeSchedule:
    return gdm(instance, beta=beta, rng=_rng(rng, seed), rooted=False,
               decompose=decompose, nested=nested, delays=delays,
               gamma=gamma, device=device, plan_backend=plan_backend)


@register_scheduler("gdm_rt", "G-DM-RT (Algorithm 4 over rooted trees, "
                              "DMA-RT groups; nested=False = flat fast "
                              "path; delays=random|spread)",
                    options=_GDM_RT_OPTS)
def _gdm_rt(instance: Instance, *, device, plan_backend, beta: float = 2.0,
            seed: int = 0, rng=None, nested: bool = True, decompose: bool = False,
            require_tree: bool = True,
            delays: str = "random", gamma=None) -> CompositeSchedule:
    return gdm(instance, beta=beta, rng=_rng(rng, seed), rooted=True,
               decompose=decompose, nested=nested, require_tree=require_tree,
               delays=delays, gamma=gamma, device=device,
               plan_backend=plan_backend)


@register_scheduler("om_alg", "O(m)Alg baseline: one-at-a-time jobs in "
                              "Algorithm 5 order, BNA per coflow",
                    options=_OM_ALG_OPTS)
def _om_alg(instance: Instance, *, device, plan_backend,
            decompose: bool = False, seed: int = 0) -> CompositeSchedule:
    # `seed` is accepted for registry uniformity; the baseline is
    # deterministic.
    del seed
    return om_alg(instance, decompose=decompose, device=device,
                  plan_backend=plan_backend)


@register_scheduler("gdm_bf", "G-DM + backfilling (§VII); exec=packet|ledger",
                    options=_GDM_OPTS + ("exec",))
def _gdm_bf(instance: Instance, *, device, plan_backend, exec: str = "packet",
            **opts) -> BackfillResult:
    return backfill(_gdm(instance, device=device, plan_backend=plan_backend,
                         **opts), exec=exec)


@register_scheduler("gdm_rt_bf", "G-DM-RT + backfilling (§VII); "
                                 "exec=packet|ledger",
                    options=_GDM_RT_OPTS + ("exec",))
def _gdm_rt_bf(instance: Instance, *, device, plan_backend,
               exec: str = "packet", **opts) -> BackfillResult:
    return backfill(_gdm_rt(instance, device=device,
                            plan_backend=plan_backend, **opts), exec=exec)


@register_scheduler("om_alg_bf", "O(m)Alg + backfilling (§VII); "
                                 "exec=packet|ledger",
                    options=_OM_ALG_OPTS + ("exec",))
def _om_alg_bf(instance: Instance, *, device, plan_backend,
               exec: str = "packet", **opts) -> BackfillResult:
    return backfill(_om_alg(instance, device=device,
                            plan_backend=plan_backend, **opts), exec=exec)


# --------------------------------------------------------------------------
# incremental online path
# --------------------------------------------------------------------------

def plan_online(instance: Instance, scheduler: "str | _Registered",
                incremental: bool = True, driver: str = "session",
                repair: bool = True, gamma="residual",
                device: "str | torch.device" = "cuda",
                plan_backend: "str | None" = None, **opts):
    """Run the §VII-C.2 online protocol with a registered scheduler on
    `device` through `plan_backend` — a thin, results-identical driver over
    a :class:`~repro_torch.core.session.SchedulerSession`
    (``driver="batch"`` selects the historical closed batch loop, the
    reference comparator).  A prebuilt scheduler (:func:`make_scheduler`)
    brings its own device and plan backend.

    incremental=True (default) replans through the engine caches —
    results-identical to a cold run, measurably faster when reschedules
    share untouched coflows.  incremental=False disables and clears the
    caches for the duration (the from-scratch comparator).

    Returns the driver's OnlineResult with `stats` filled in: wall-clock
    seconds, reschedule count, per-cache hits/misses/hit-rate deltas
    attributable to this run, and (session driver) the session's
    repair/replan counters under ``stats["session"]``.
    """
    from .online import simulate_online

    if isinstance(scheduler, str):
        scheduler = make_scheduler(scheduler, device=device,
                                   plan_backend=plan_backend, **opts)
    elif opts:
        raise TypeError("scheduler options are only accepted with a "
                        "scheduler name, not a prebuilt scheduler")

    def _run():
        before = backend.cache_stats()
        t0 = time.perf_counter()
        res = simulate_online(instance, scheduler, driver=driver,
                              repair=repair, gamma=gamma,
                              device=scheduler.device,
                              plan_backend=scheduler.plan_backend)
        wall = time.perf_counter() - t0
        after = backend.cache_stats()
        stats: dict = {"wall_s": wall, "reschedules": res.reschedules,
                       "incremental": incremental, "driver": driver}
        if "session" in res.stats:
            stats["session"] = res.stats["session"]
        for cache in ("bna", "order", "group"):
            hits = after[cache]["hits"] - before[cache]["hits"]
            misses = after[cache]["misses"] - before[cache]["misses"]
            total = hits + misses
            stats[cache] = {"hits": hits, "misses": misses,
                            "hit_rate": (hits / total) if total else 0.0}
        res.stats = stats
        return res

    if incremental:
        return _run()
    with backend.no_caches():
        return _run()

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
========== ==============================================================

Every plan runs on a device: ``plan(instance, name, device="cuda")`` (the
default) decomposes the coflows through the ``bna_step`` kernel and
computes every merge_and_fix alpha through the ``coflow_merge`` kernel;
``device="cpu"`` runs their plain PyTorch versions.  The plans are
bit-identical.  Asking for ``cuda`` without a card raises.

Adding a scheduler is one decorator::

    @register_scheduler("my_sched", "one-line description",
                        options=("seed",))
    def _my_sched(instance, *, device, seed=0):
        return ...  # CompositeSchedule
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..kernels import resolve_device
from . import backend
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
]


@dataclass
class PlanResult:
    """A planned schedule plus uniform metric access."""

    name: str
    schedule: CompositeSchedule

    def transcript(self) -> Transcript:
        return self.schedule.transcript()

    def job_completions(self) -> dict[int, float]:
        return self.schedule.job_completions()

    def twct(self, from_release: bool = False) -> float:
        return self.schedule.twct(from_release)

    @property
    def makespan(self) -> float:
        return float(self.schedule.makespan)


_Factory = Callable[..., CompositeSchedule]


@dataclass
class _Entry:
    factory: _Factory
    doc: str
    options: tuple[str, ...]


_REGISTRY: dict[str, _Entry] = {}


def register_scheduler(name: str, doc: str = "",
                       options: tuple[str, ...] = ()):
    """Register `factory(instance, *, device, **opts)` under `name`
    (decorator).

    ``options`` declares the option names the factory accepts;
    :func:`make_scheduler` rejects anything else.  The declared tuple is
    checked against the factory's signature at registration: every
    keyword-only parameter but ``device`` must be declared, and every
    declared option must be a real parameter."""

    def deco(factory: _Factory) -> _Factory:
        if name in _REGISTRY:
            raise ValueError(f"scheduler {name!r} already registered")
        params = inspect.signature(factory).parameters.values()
        kw = {p.name for p in params if p.kind == p.KEYWORD_ONLY}
        if "device" not in kw:
            raise ValueError(f"scheduler {name!r}: the factory must take a "
                             f"keyword-only 'device'")
        kw.discard("device")
        declared = set(options)
        if kw != declared:
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
    """A registry entry bound to its options and device."""

    name: str
    device: torch.device
    opts: dict = field(default_factory=dict)

    def plan_full(self, instance: Instance) -> PlanResult:
        # instance-level prefetch: one batched decomposition on the device
        # warms the BNA cache for every coflow BEFORE the factory walks the
        # jobs one at a time (results-identical either way)
        backend.prefetch_bna((c.demand for j in instance.jobs
                              for c in j.coflows), device=self.device)
        return PlanResult(self.name, _REGISTRY[self.name].factory(
            instance, device=self.device, **self.opts))

    def plan(self, instance: Instance) -> Transcript:
        return self.plan_full(instance).transcript()


def make_scheduler(name: str, device: "str | torch.device" = "cuda",
                   **opts) -> _Registered:
    """Instantiate a registered scheduler with bound options on `device`.
    An unknown option raises immediately with the valid set; ``cuda``
    without a card raises."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown scheduler {name!r}; "
                       f"registered: {sorted(_REGISTRY)}")
    unknown = sorted(set(opts) - set(_REGISTRY[name].options))
    if unknown:
        raise TypeError(
            f"unknown option(s) {unknown} for scheduler {name!r}; "
            f"valid options: {sorted(_REGISTRY[name].options)}")
    return _Registered(name, resolve_device(device), opts)


def plan(instance: Instance, name: str,
         device: "str | torch.device" = "cuda", **opts) -> PlanResult:
    """One-shot: plan `instance` with scheduler `name` on `device`."""
    return make_scheduler(name, device=device, **opts).plan_full(instance)


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
def _gdm(instance: Instance, *, device, beta: float = 2.0, seed: int = 0,
         rng=None, nested: bool = True, decompose: bool = False,
         delays: str = "random", gamma=None) -> CompositeSchedule:
    return gdm(instance, beta=beta, rng=_rng(rng, seed), rooted=False,
               decompose=decompose, nested=nested, delays=delays,
               gamma=gamma, device=device)


@register_scheduler("gdm_rt", "G-DM-RT (Algorithm 4 over rooted trees, "
                              "DMA-RT groups; nested=False = flat fast "
                              "path; delays=random|spread)",
                    options=_GDM_RT_OPTS)
def _gdm_rt(instance: Instance, *, device, beta: float = 2.0, seed: int = 0,
            rng=None, nested: bool = True, decompose: bool = False,
            require_tree: bool = True,
            delays: str = "random", gamma=None) -> CompositeSchedule:
    return gdm(instance, beta=beta, rng=_rng(rng, seed), rooted=True,
               decompose=decompose, nested=nested, require_tree=require_tree,
               delays=delays, gamma=gamma, device=device)


@register_scheduler("om_alg", "O(m)Alg baseline: one-at-a-time jobs in "
                              "Algorithm 5 order, BNA per coflow",
                    options=_OM_ALG_OPTS)
def _om_alg(instance: Instance, *, device, decompose: bool = False,
            seed: int = 0) -> CompositeSchedule:
    # `seed` is accepted for registry uniformity; the baseline is
    # deterministic.
    del seed
    return om_alg(instance, decompose=decompose, device=device)

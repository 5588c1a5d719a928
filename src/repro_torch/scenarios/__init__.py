"""Scenario registry + workload zoo (mirrors the scheduler registry).

    from repro_torch import scenarios

    scenarios.names()                       # ['alibaba_sparse', ..., 'fb_like', ...]
    built = scenarios.build("incast", m=48, seed=0, scale=0.5)
    built.instance                          # repro_torch.core Instance
    built.meta                              # DAG family, arrival model, bounds
    scenarios.check_bounds(built)           # generator kept its contract

See ``registry.py`` for the machinery and ``zoo.py`` for the scenarios.
"""
from .registry import (BuiltScenario, Scenario, ScenarioMeta, available,
                       build, check_bounds, get, names, register,
                       scheduler_opts, strip_releases)
from . import zoo  # noqa: F401  (imports populate the registry)

__all__ = [
    "BuiltScenario",
    "Scenario",
    "ScenarioMeta",
    "available",
    "build",
    "check_bounds",
    "get",
    "names",
    "register",
    "scheduler_opts",
    "strip_releases",
]

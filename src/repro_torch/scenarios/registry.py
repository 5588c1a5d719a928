"""String-keyed scenario registry, mirroring the scheduler registry in
``core/engine.py``.

A *scenario* is a named, seeded workload generator: ``build()`` returns a
:class:`BuiltScenario` — the concrete :class:`~repro_torch.core.types.Instance`
plus :class:`ScenarioMeta` describing what the generator guarantees (DAG
family, arrival model, weight model, and instance-checkable bounds on flow
sizes / widths / job shapes).  The cross-product test harness
(``tests/test_torch_scenarios.py``) runs every registered scenario against
every registered scheduler and asserts the repo's core invariants;
``check_bounds`` is the metadata half of that contract.  Every generator
draws from ``np.random.default_rng(seed)`` in the order
``repro.scenarios`` does, so both packages build the same instance from
the same keywords.

Adding a scenario is one decorator::

    @register("my_trace", "one-line description")
    def _my_trace(*, m=None, seed=0, scale=1.0, **kw) -> BuiltScenario:
        ...

Builder keyword conventions (every scenario accepts them): ``m`` — port
count (None = scenario default), ``seed`` — RNG seed, ``scale`` — shrinks
job/coflow counts proportionally (tests and fast benchmarks pass small
values).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..core.types import Instance, is_rooted_tree, topological_order

__all__ = [
    "ScenarioMeta",
    "BuiltScenario",
    "Scenario",
    "register",
    "get",
    "names",
    "available",
    "build",
    "check_bounds",
    "scheduler_opts",
    "strip_releases",
]

#: DAG families a scenario may declare (checked by ``check_bounds``).
DAG_FAMILIES = ("general", "rooted_tree", "chain", "independent")
#: Arrival models a scenario may declare.
ARRIVALS = ("offline", "poisson")


@dataclass(frozen=True)
class ScenarioMeta:
    """What a scenario's generator guarantees about every built instance.

    ``bounds`` keys (all optional, all instance-checkable):
      flow_min   — every positive demand entry >= flow_min
      entry_max  — every demand entry <= entry_max (a safe upper bound;
                   exact for collision-free generators)
      width_max  — nnz of every coflow demand <= width_max
      mu_max     — every job has <= mu_max coflows
      n_jobs_max — the instance has <= n_jobs_max jobs
    """

    name: str
    dag_family: str            # one of DAG_FAMILIES
    arrival: str               # one of ARRIVALS
    weights: str = "equal"     # "equal" | "random"
    bounds: dict = field(default_factory=dict)


@dataclass
class BuiltScenario:
    """A concrete instance plus the metadata it was generated under."""

    instance: Instance
    meta: ScenarioMeta


@dataclass(frozen=True)
class Scenario:
    """A registry entry: named, seeded generator + description."""

    name: str
    doc: str
    builder: Callable[..., BuiltScenario]

    def build(self, **kw) -> BuiltScenario:
        return self.builder(**kw)


_REGISTRY: dict[str, Scenario] = {}


def register(name: str, doc: str = ""):
    """Register ``builder(**kw) -> BuiltScenario`` under ``name``
    (decorator)."""

    def deco(builder):
        if name in _REGISTRY:
            raise ValueError(f"scenario {name!r} already registered")
        _REGISTRY[name] = Scenario(name, doc or (builder.__doc__ or "").strip(),
                                   builder)
        return builder

    return deco


def get(name: str) -> Scenario:
    if name not in _REGISTRY:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> list[str]:
    return sorted(_REGISTRY)


def available() -> dict[str, str]:
    """name -> one-line description, for CLIs and reports."""
    return {name: s.doc for name, s in sorted(_REGISTRY.items())}


def build(name: str, **kw) -> BuiltScenario:
    """One-shot: build scenario ``name`` with the given parameters."""
    return get(name).build(**kw)


def _is_chain(n: int, edges: list[tuple[int, int]]) -> bool:
    return sorted(edges) == [(k, k + 1) for k in range(n - 1)]


def check_bounds(built: BuiltScenario) -> None:
    """Assert the built instance satisfies everything its metadata declares.

    Property tests run this over many seeds; a failure means the generator
    broke its own contract, not that a scheduler misbehaved."""
    inst, meta = built.instance, built.meta
    assert meta.dag_family in DAG_FAMILIES, meta.dag_family
    assert meta.arrival in ARRIVALS, meta.arrival
    b = meta.bounds

    if "n_jobs_max" in b:
        assert inst.n <= b["n_jobs_max"], f"{inst.n} jobs > {b['n_jobs_max']}"
    releases = [j.release for j in inst.jobs]
    if meta.arrival == "offline":
        assert all(r == 0 for r in releases), "offline scenario has releases"
    else:
        assert all(r >= 0 for r in releases)
        assert releases == sorted(releases), "arrivals not in job order"

    for j in inst.jobs:
        # DAG family shape (acyclicity re-checked explicitly)
        topological_order(j.mu, j.edges)
        if meta.dag_family == "rooted_tree" and j.mu > 1:
            assert is_rooted_tree(j), f"job {j.jid} not a rooted tree"
        elif meta.dag_family == "chain":
            assert _is_chain(j.mu, j.edges), f"job {j.jid} not a chain"
        elif meta.dag_family == "independent":
            assert not j.edges, f"job {j.jid} has edges"
        if meta.weights == "equal":
            assert j.weight == 1.0
        else:
            assert 0.0 < j.weight <= 1.0
        if "mu_max" in b:
            assert j.mu <= b["mu_max"], f"job {j.jid}: mu {j.mu}"
        for c in j.coflows:
            pos = c.demand[c.demand > 0]
            assert pos.size > 0, f"coflow ({j.jid},{c.cid}) has zero demand"
            if "flow_min" in b:
                assert int(pos.min()) >= b["flow_min"]
            if "entry_max" in b:
                assert int(c.demand.max()) <= b["entry_max"]
            if "width_max" in b:
                assert int((c.demand > 0).sum()) <= b["width_max"]


def scheduler_opts(scheduler: str, meta: ScenarioMeta) -> dict:
    """Extra engine options a scheduler needs to run on this scenario.

    G-DM-RT's tree machinery needs ``require_tree=False`` on general-DAG
    workloads (DMA-SRT then falls back to precedence-exact start times);
    every other (scheduler, scenario) pair runs with defaults."""
    if scheduler.startswith("gdm_rt") and meta.dag_family == "general":
        return {"require_tree": False}
    return {}


def strip_releases(inst: Instance) -> Instance:
    """The release-0 (offline) view of an instance — the online/offline
    agreement invariant compares schedules on this."""
    import dataclasses

    return Instance(inst.m, [dataclasses.replace(j, release=0)
                             for j in inst.jobs])

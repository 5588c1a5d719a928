"""The workload zoo: every scenario the registry ships with.

The paper's evaluation (§VII) is calibrated to a single Facebook
Hive/MapReduce trace; relative scheduler performance is known to shift
dramatically across trace shapes (experimental coflow-scheduler analyses,
and follow-up work on coflows with precedence constraints).  Each scenario
here stresses a different axis — port skew, coflow width, DAG depth/width,
arrival model — and declares instance-checkable bounds so the cross-product
test harness can hold every scheduler to the same invariants on every
shape.

All builders follow the registry conventions: ``m`` (ports, None = scenario
default), ``seed``, and ``scale`` (shrinks job/coflow counts — tests pass
tiny values).  Everything is built on the generalized ``core/traces.py``
primitives; ``dist_collectives`` additionally routes through the
``repro_torch.dist`` collective->coflow planner.
"""
from __future__ import annotations

import numpy as np

from ..core.traces import (build_jobs, paper_workload, poisson_releases,
                           port_skew, sample_coflows, sample_sizes, theta0)
from .registry import BuiltScenario, ScenarioMeta, register

__all__: list[str] = []    # scenarios are reached through the registry


def _count(base: int, scale: float, lo: int = 2) -> int:
    return max(lo, int(round(base * scale)))


# --------------------------------------------------------------------------
# the paper's calibrated trace (general DAGs, and the rooted-tree variant)
# --------------------------------------------------------------------------

@register("fb_like", "paper §VII FB-trace-calibrated workload, general DAGs")
def _fb_like(*, m: int | None = None, seed: int = 0, scale: float = 1.0,
             mu_bar: int = 5, weights: str = "equal") -> BuiltScenario:
    m = m or 50
    inst = paper_workload(m=m, mu_bar=mu_bar, seed=seed, scale=scale,
                          rooted=False, weights=weights)
    return BuiltScenario(inst, _fb_meta("fb_like", "general", m, scale,
                                        mu_bar, weights))


@register("fb_like_rt", "FB-trace-calibrated workload, rooted-tree DAGs "
                        "(Hive/MapReduce stage trees)")
def _fb_like_rt(*, m: int | None = None, seed: int = 0, scale: float = 1.0,
                mu_bar: int = 5, weights: str = "equal") -> BuiltScenario:
    m = m or 50
    inst = paper_workload(m=m, mu_bar=mu_bar, seed=seed, scale=scale,
                          rooted=True, weights=weights)
    return BuiltScenario(inst, _fb_meta("fb_like_rt", "rooted_tree", m, scale,
                                        mu_bar, weights))


def _fb_meta(name: str, family: str, m: int, scale: float, mu_bar: int,
             weights: str, arrival: str = "offline") -> ScenarioMeta:
    n = max(1, int(round(267 * scale)))
    wmax = min(max(max(10, int(round(21170 * scale))), 11), m * (m - 1))
    return ScenarioMeta(name, family, arrival, weights, bounds=dict(
        flow_min=1, width_max=wmax, entry_max=2472 * wmax,
        mu_max=max(2 * mu_bar - 1, 1), n_jobs_max=n))


# --------------------------------------------------------------------------
# non-FB trace shapes
# --------------------------------------------------------------------------

@register("alibaba_sparse", "alibaba-style sparse fan-in: narrow coflows, "
                            "zipf-skewed receivers, fan-in trees")
def _alibaba_sparse(*, m: int | None = None, seed: int = 0,
                    scale: float = 1.0) -> BuiltScenario:
    m = m or 50
    n = _count(60, scale)
    w_hi = max(2, m // 2)
    demands = sample_coflows(
        m, n, seed=seed,
        width_dist=("loguniform", 1, w_hi),
        size_dist=("lognormal", 4.0, 2.0), size_clip=(1, 4096),
        dst_skew=port_skew(m, "zipf", a=1.5))
    inst = build_jobs(demands, mu_bar=4, seed=seed, dag="tree")
    wmax = min(w_hi, m * (m - 1))
    meta = ScenarioMeta("alibaba_sparse", "rooted_tree", "offline", "equal",
                        bounds=dict(flow_min=1, width_max=wmax,
                                    entry_max=4096 * wmax, mu_max=7,
                                    n_jobs_max=n))
    return BuiltScenario(inst, meta)


@register("incast", "incast-heavy: many senders converge on a few hot "
                    "receivers (95% of traffic on m/8 ports)")
def _incast(*, m: int | None = None, seed: int = 0,
            scale: float = 1.0) -> BuiltScenario:
    m = m or 48
    n = _count(40, scale)
    w_lo, w_hi = max(2, m // 2), min(2 * m, m * (m - 1))
    demands = sample_coflows(
        m, n, seed=seed,
        width_dist=("uniform", w_lo, w_hi),
        size_dist=("uniform", 1, 64), size_clip=(1, 64),
        dst_skew=port_skew(m, "hotspot", hot=max(1, m // 8), hot_mass=0.95))
    inst = build_jobs(demands, mu_bar=3, seed=seed, dag="tree")
    meta = ScenarioMeta("incast", "rooted_tree", "offline", "equal",
                        bounds=dict(flow_min=1, width_max=w_hi,
                                    entry_max=64 * w_hi, mu_max=5,
                                    n_jobs_max=n))
    return BuiltScenario(inst, meta)


@register("shuffle_heavy", "shuffle-heavy all-to-all: dense demand on every "
                           "port pair, 3-stage map/shuffle/reduce chains")
def _shuffle_heavy(*, m: int | None = None, seed: int = 0,
                   scale: float = 1.0) -> BuiltScenario:
    m = m or 32
    n_jobs = _count(12, scale, lo=1)
    rng = np.random.default_rng(seed)
    off_diag = ~np.eye(m, dtype=bool)
    demands = []
    for _ in range(3 * n_jobs):
        d = np.zeros((m, m), dtype=np.int64)
        d[off_diag] = sample_sizes(rng, m * (m - 1),
                                   ("lognormal", 2.0, 1.0), clip=(1, 256))
        demands.append(d)
    inst = build_jobs(demands, seed=seed, dag="chain", mu_fixed=3)
    meta = ScenarioMeta("shuffle_heavy", "chain", "offline", "equal",
                        bounds=dict(flow_min=1, width_max=m * (m - 1),
                                    entry_max=256, mu_max=3,
                                    n_jobs_max=3 * n_jobs))
    return BuiltScenario(inst, meta)


@register("wide_shallow", "wide-and-shallow map-reduce: many parallel map "
                          "coflows feeding one reduce (depth-1 star)")
def _wide_shallow(*, m: int | None = None, seed: int = 0,
                  scale: float = 1.0, mu: int = 6) -> BuiltScenario:
    m = m or 40
    n_jobs = _count(10, scale, lo=1)
    demands = sample_coflows(
        m, mu * n_jobs, seed=seed,
        width_dist=("uniform", 1, m),
        size_dist=("uniform", 1, 128), size_clip=(1, 128))
    inst = build_jobs(demands, seed=seed, dag="star", mu_fixed=mu)
    meta = ScenarioMeta("wide_shallow", "rooted_tree", "offline", "equal",
                        bounds=dict(flow_min=1, width_max=m,
                                    entry_max=128 * m, mu_max=mu,
                                    n_jobs_max=mu * n_jobs))
    return BuiltScenario(inst, meta)


@register("deep_chain", "deep-chain DAGs: 10-stage sequential pipelines "
                        "(stresses dependency depth)")
def _deep_chain(*, m: int | None = None, seed: int = 0,
                scale: float = 1.0, depth: int = 10) -> BuiltScenario:
    m = m or 24
    n_jobs = _count(8, scale, lo=1)
    demands = sample_coflows(
        m, depth * n_jobs, seed=seed,
        width_dist=("uniform", 1, m),
        size_dist=("lognormal", 2.0, 1.2), size_clip=(1, 128))
    inst = build_jobs(demands, seed=seed, dag="chain", mu_fixed=depth)
    meta = ScenarioMeta("deep_chain", "chain", "offline", "equal",
                        bounds=dict(flow_min=1, width_max=m,
                                    entry_max=128 * m, mu_max=depth,
                                    n_jobs_max=depth * n_jobs))
    return BuiltScenario(inst, meta)


@register("online_poisson", "weighted Poisson online arrivals over the "
                            "FB-calibrated trace (paper §VII-B.2)")
def _online_poisson(*, m: int | None = None, seed: int = 0,
                    scale: float = 1.0, mu_bar: int = 4,
                    load: float = 4.0) -> BuiltScenario:
    m = m or 50
    base = paper_workload(m=m, mu_bar=mu_bar, seed=seed, scale=scale,
                          rooted=False, weights="random")
    inst = poisson_releases(base, theta=theta0(base) * load, seed=seed)
    meta = _fb_meta("online_poisson", "general", m, scale, mu_bar, "random",
                    arrival="poisson")
    return BuiltScenario(inst, meta)


@register("dist_collectives", "collective->coflow planner workload: a "
                              "synthetic compiled-step collective program "
                              "on a 2 x m/2 fabric (repro.dist; m must be "
                              "even and >= 4)")
def _dist_collectives(*, m: int | None = None, seed: int = 0,
                      scale: float = 1.0, max_mb: int = 8) -> BuiltScenario:
    from ..dist.planner import coflows_from_step, synthetic_collective_ops

    m = m or 16
    if m < 4 or m % 2:
        raise ValueError(f"dist_collectives needs an even m >= 4 "
                         f"(2 x m/2 fabric, both axes >= 2), got {m}")
    rows, cols = 2, m // 2
    n_ops = _count(16, scale)
    ops = synthetic_collective_ops(n_ops=n_ops, seed=seed, max_mb=max_mb)
    n_buckets = max(1, n_ops // 4)
    inst = coflows_from_step(ops, rows, cols, n_buckets)
    meta = ScenarioMeta("dist_collectives", "chain", "offline", "equal",
                        bounds=dict(flow_min=1, width_max=m * (m - 1),
                                    entry_max=max_mb,
                                    mu_max=-(-n_ops // n_buckets),
                                    n_jobs_max=n_buckets))
    return BuiltScenario(inst, meta)

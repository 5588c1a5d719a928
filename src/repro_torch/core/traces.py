"""Workload generation (paper §VII), as ``repro.core.traces``: the
calibrated trace behind ``paper_workload``, the generalized primitives the
scenario registry (``repro_torch.scenarios``) and the streaming harness
are built on, and ``workload_stats``.

The paper evaluates on a Facebook Hive/MapReduce trace (150 racks, 267
coflows, flow sizes in [1, 2472], coflow effective sizes in [5, 232145],
aggregate effective size Delta = 440419).  That trace is not
redistributable, so `fb_like_coflows` generates a calibrated synthetic
workload that matches the published marginal statistics: log-uniform
coflow widths in [10, 21170] flows, heavy-tailed (lognormal) flow sizes
clipped to [1, 2472], uniform port mapping.

Job construction follows §VII: coflows are randomly partitioned into jobs
with mu_bar coflows on average; general-DAG jobs draw each forward edge
with probability 0.5; rooted-tree jobs keep one out-edge per non-root node
to a random higher-indexed node.  Every draw comes from an explicitly
seeded ``np.random.default_rng``, in the reference's order, so the port
builds the same instances as the reference from the same seed.

The generalized primitives (``sample_width``, ``sample_sizes``,
``port_skew``, ``sample_coflows``) draw the reference's numpy streams
exactly, and ``poisson_releases`` / ``theta0`` give the paper's online
arrivals (§VII-B.2).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .types import (Coflow, Instance, Job, children_of, coflow_layers,
                    is_rooted_tree, parents_of)

__all__ = [
    "PAPER_STATS",
    "fb_like_coflows",
    "dag_edges",
    "build_jobs",
    "paper_workload",
    "poisson_releases",
    "theta0",
    "sample_width",
    "sample_sizes",
    "port_skew",
    "sample_coflows",
    "workload_stats",
]

# Published trace statistics (paper §VII "Workload")
PAPER_STATS = dict(m=150, n_coflows=267, min_flow=1, max_flow=2472,
                   min_width=10, max_width=21170, delta=440419)

def fb_like_coflows(
    m: int = 150,
    n_coflows: int = 267,
    seed: int = 0,
    scale: float = 1.0,
    min_flow: int = 1,
    max_flow: int = 2472,
    min_width: int = 10,
    max_width: int = 21170,
) -> list[np.ndarray]:
    """Synthetic FB-like coflows: list of (m, m) int64 demand matrices.

    scale < 1 shrinks coflow count and widths proportionally (benchmark fast
    mode); statistics per coflow are preserved."""
    rng = np.random.default_rng(seed)
    n = max(1, int(round(n_coflows * scale)))
    wmax = max(min_width, int(round(max_width * scale)))
    demands: list[np.ndarray] = []
    for _ in range(n):
        width = int(round(10 ** rng.uniform(math.log10(min_width),
                                            math.log10(max(wmax, min_width + 1)))))
        width = min(width, m * (m - 1))
        sizes = np.clip(np.round(rng.lognormal(mean=3.0, sigma=1.6, size=width)),
                        min_flow, max_flow).astype(np.int64)
        d = np.zeros((m, m), dtype=np.int64)
        s = rng.integers(0, m, size=width)
        r = rng.integers(0, m, size=width)
        bad = s == r
        r[bad] = (r[bad] + 1 + rng.integers(0, m - 1, size=int(bad.sum()))) % m
        np.add.at(d, (s, r), sizes)
        demands.append(d)
    return demands


# --------------------------------------------------------------------------
# generalized primitives (scenario registry building blocks)
# --------------------------------------------------------------------------

def sample_width(rng: np.random.Generator, dist: tuple, cap: int) -> int:
    """One coflow width from a parameterized distribution, capped at `cap`.

    dist forms: ("loguniform", lo, hi) | ("uniform", lo, hi) | ("fixed", k).
    """
    kind = dist[0]
    if kind == "loguniform":
        lo, hi = int(dist[1]), max(int(dist[2]), int(dist[1]) + 1)
        w = int(round(10 ** rng.uniform(math.log10(max(lo, 1)),
                                        math.log10(hi))))
    elif kind == "uniform":
        w = int(rng.integers(int(dist[1]), int(dist[2]) + 1))
    elif kind == "fixed":
        w = int(dist[1])
    else:
        raise ValueError(f"unknown width distribution {kind!r}")
    return max(1, min(w, cap))


def sample_sizes(
    rng: np.random.Generator, n: int, dist: tuple,
    clip: tuple[int, int] = (1, 2472),
) -> np.ndarray:
    """`n` flow sizes from a parameterized distribution, clipped to `clip`.

    dist forms: ("lognormal", mean, sigma) | ("uniform", lo, hi) |
    ("pareto", shape, scale) | ("fixed", v).
    """
    kind = dist[0]
    if kind == "lognormal":
        raw = rng.lognormal(mean=float(dist[1]), sigma=float(dist[2]), size=n)
    elif kind == "uniform":
        raw = rng.uniform(float(dist[1]), float(dist[2]), size=n)
    elif kind == "pareto":
        raw = float(dist[2]) * (1.0 + rng.pareto(float(dist[1]), size=n))
    elif kind == "fixed":
        raw = np.full(n, float(dist[1]))
    else:
        raise ValueError(f"unknown size distribution {kind!r}")
    return np.clip(np.round(raw), clip[0], clip[1]).astype(np.int64)


def port_skew(m: int, kind: str = "uniform", *, hot: int = 1,
              hot_mass: float = 0.9, a: float = 1.2) -> np.ndarray | None:
    """Port-popularity map: probability vector over the m ports (or None
    for uniform).

    kinds: "uniform"; "hotspot" — `hot` ports share `hot_mass` of the
    traffic (incast/alibaba fan-in); "zipf" — p(rank) ∝ 1/rank^a.
    """
    if kind == "uniform":
        return None
    if kind == "hotspot":
        hot = max(1, min(int(hot), m))
        p = np.full(m, (1.0 - hot_mass) / max(m - hot, 1))
        p[:hot] = hot_mass / hot
        if hot == m:
            p[:] = 1.0 / m
        return p / p.sum()
    if kind == "zipf":
        p = 1.0 / np.arange(1, m + 1, dtype=np.float64) ** a
        return p / p.sum()
    raise ValueError(f"unknown port skew {kind!r}")


def sample_coflows(
    m: int,
    n_coflows: int,
    seed: int = 0,
    *,
    width_dist: tuple = ("loguniform", 10, 21170),
    size_dist: tuple = ("lognormal", 3.0, 1.6),
    size_clip: tuple[int, int] = (1, 2472),
    src_skew: np.ndarray | None = None,
    dst_skew: np.ndarray | None = None,
) -> list[np.ndarray]:
    """Generalized coflow sampler: `fb_like_coflows` with parameterized
    width/size distributions and per-port popularity maps.

    Flows landing on the same (src, dst) pair accumulate, exactly like the
    FB sampler; self-loops are remapped to a uniformly-random other port."""
    rng = np.random.default_rng(seed)
    demands: list[np.ndarray] = []
    for _ in range(max(1, n_coflows)):
        width = sample_width(rng, width_dist, cap=m * (m - 1))
        sizes = sample_sizes(rng, width, size_dist, size_clip)
        s = rng.choice(m, size=width, p=src_skew)
        r = rng.choice(m, size=width, p=dst_skew)
        bad = s == r
        r[bad] = (r[bad] + 1 + rng.integers(0, m - 1, size=int(bad.sum()))) % m
        d = np.zeros((m, m), dtype=np.int64)
        np.add.at(d, (s, r), sizes)
        demands.append(d)
    return demands


def dag_edges(
    n: int, family: str, rng: np.random.Generator, edge_prob: float = 0.5,
) -> list[tuple[int, int]]:
    """Starts-After edges over coflows 0..n-1 from a named DAG family.

    families: "general" (each forward edge w.p. `edge_prob` — the paper's
    §VII random DAG), "tree" (fan-in tree toward root n-1 — the paper's
    rooted conversion), "chain" (0 -> 1 -> ... -> n-1), "star" (every
    non-root -> root n-1: wide-and-shallow map-reduce), "independent"
    (no edges).  "general"/"tree" consume the same RNG stream as the
    legacy `build_jobs` branches."""
    edges: list[tuple[int, int]] = []
    if n <= 1:
        return edges
    if family == "tree":
        for a in range(n - 1):
            b = int(rng.integers(a + 1, n))
            edges.append((a, b))
    elif family == "general":
        for a in range(n):
            for b in range(a + 1, n):
                if rng.random() < edge_prob:
                    edges.append((a, b))
    elif family == "chain":
        edges = [(k, k + 1) for k in range(n - 1)]
    elif family == "star":
        edges = [(a, n - 1) for a in range(n - 1)]
    elif family == "independent":
        pass
    else:
        raise ValueError(f"unknown DAG family {family!r}")
    return edges


def build_jobs(
    demands: list[np.ndarray],
    mu_bar: int = 5,
    seed: int = 0,
    rooted: bool = False,
    weights: str = "equal",   # "equal" | "random"
    dag: str | None = None,   # None -> "tree" if rooted else "general"
    mu_fixed: int | None = None,  # exact coflows per job (else ~mu_bar avg)
) -> Instance:
    rng = np.random.default_rng(seed + 1)
    m = demands[0].shape[0]
    order = rng.permutation(len(demands))
    family = dag if dag is not None else ("tree" if rooted else "general")
    jobs: list[Job] = []
    pos = 0
    jid = 0
    while pos < len(order):
        if mu_fixed is not None:
            size = max(1, int(mu_fixed))
        else:
            size = int(rng.integers(1, 2 * mu_bar)) if mu_bar > 1 else 1
        group = order[pos:pos + size]
        pos += size
        coflows = [Coflow(jid, k, demands[g]) for k, g in enumerate(group)]
        edges = dag_edges(len(coflows), family, rng)
        w = 1.0 if weights == "equal" else float(rng.uniform(0.0, 1.0)) or 1e-3
        jobs.append(Job(jid, coflows, edges, weight=w, release=0))
        jid += 1
    return Instance(m, jobs)


def paper_workload(
    m: int = 150,
    mu_bar: int = 5,
    seed: int = 0,
    scale: float = 1.0,
    rooted: bool = False,
    weights: str = "equal",
) -> Instance:
    """One line to the paper's §VII setup (synthetic-calibrated)."""
    demands = fb_like_coflows(m=m, seed=seed, scale=scale)
    return build_jobs(demands, mu_bar=mu_bar, seed=seed, rooted=rooted, weights=weights)


def theta0(instance: Instance) -> float:
    """Base arrival rate (paper §VII-B.2): total #coflows / sum of coflow
    effective sizes."""
    n_cf = sum(j.mu for j in instance.jobs)
    tot = sum(c.D for j in instance.jobs for c in j.coflows)
    return n_cf / max(tot, 1)


def poisson_releases(instance: Instance, theta: float, seed: int = 0) -> Instance:
    """Return a copy of the instance with Poisson(theta) arrival times."""
    rng = np.random.default_rng(seed + 2)
    gaps = rng.exponential(1.0 / theta, size=len(instance.jobs))
    cum = np.cumsum(gaps)
    if cum.size and cum[-1] >= 2.0**53:
        # float64 integer exactness ends at 2^53; see stream.arrival_times
        raise ValueError(
            f"cumulative release time {cum[-1]:.3g} exceeds the float64 "
            "integer-exact range (2^53); raise theta or shrink the instance")
    times = np.floor(cum).astype(np.int64)
    jobs = [dataclasses.replace(j, release=int(t))
            for j, t in zip(instance.jobs, times)]
    return Instance(instance.m, jobs)


def workload_stats(instance: Instance) -> dict:
    """The trace statistics the paper reports (``PAPER_STATS``'s keys) plus
    effective sizes and the DAG shape: depth is the longest Starts-After
    path (edges), fan-in / fan-out the most parents / children of any
    coflow, tree fraction the share of jobs whose graph is a rooted tree."""
    sizes = [int(c.demand[c.demand > 0].min()) for j in instance.jobs
             for c in j.coflows if (c.demand > 0).any()]
    sizes_max = [int(c.demand.max()) for j in instance.jobs for c in j.coflows]
    eff = [c.D for j in instance.jobs for c in j.coflows]
    widths = [int((c.demand > 0).sum()) for j in instance.jobs for c in j.coflows]
    depths = [max(len(coflow_layers(j)) - 1, 0) for j in instance.jobs]
    fan_in = [max((len(p) for p in parents_of(j.mu, j.edges)), default=0)
              for j in instance.jobs]
    fan_out = [max((len(c) for c in children_of(j.mu, j.edges)), default=0)
               for j in instance.jobs]
    trees = [is_rooted_tree(j) for j in instance.jobs]
    return dict(
        m=instance.m,
        n_jobs=instance.n,
        n_coflows=sum(j.mu for j in instance.jobs),
        min_flow=min(sizes, default=0),
        max_flow=max(sizes_max, default=0),
        min_width=min(widths, default=0),
        max_width=max(widths, default=0),
        min_eff=min(eff, default=0),
        max_eff=max(eff, default=0),
        delta=instance.delta(),
        dag_depth_max=max(depths, default=0),
        dag_depth_mean=float(np.mean(depths)) if depths else 0.0,
        max_fan_in=max(fan_in, default=0),
        max_fan_out=max(fan_out, default=0),
        tree_fraction=float(np.mean(trees)) if trees else 0.0,
    )

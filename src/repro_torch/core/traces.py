"""Workload generation (paper §VII) — the part of ``repro.core.traces``
that ``paper_workload`` needs.

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
"""
from __future__ import annotations

import math

import numpy as np

from .types import Coflow, Instance, Job

__all__ = [
    "fb_like_coflows",
    "dag_edges",
    "build_jobs",
    "paper_workload",
]

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

"""Core data types for coflow-DAG scheduling (Shafiee & Ghaderi 2020).

Model (paper §II): an m x m non-blocking switch; each coflow is an m x m
integer demand matrix; each multi-stage job is a DAG over its coflows with
Starts-After edges (a -> b means a must complete before b starts).

All demands/durations are integer (paper: "file sizes of flows are integers").
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

__all__ = [
    "Coflow",
    "Job",
    "Instance",
    "loads",
    "effective_size",
    "aggregate_size",
    "topological_order",
    "parents_of",
    "children_of",
    "coflow_layers",
    "critical_path_size",
    "is_rooted_tree",
    "is_rooted_forest",
    "validate_dag",
]


def loads(demand: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-server loads (Definition 1): d_s row sums, d_r column sums."""
    return demand.sum(axis=1), demand.sum(axis=0)


def effective_size(demand: np.ndarray) -> int:
    """Effective size D (Definition 1): max load any port must send/receive."""
    if demand.size == 0:
        return 0
    ds, dr = loads(demand)
    return int(max(ds.max(initial=0), dr.max(initial=0)))


def aggregate_size(demands: Iterable[np.ndarray]) -> int:
    """Aggregate size of a set of coflows (Definition 2): effective size of the sum."""
    total = None
    for d in demands:
        total = d.astype(np.int64, copy=True) if total is None else total + d
    if total is None:
        return 0
    return effective_size(total)


@dataclass
class Coflow:
    """A coflow: an m x m integer demand matrix, identified within its job."""

    jid: int
    cid: int
    demand: np.ndarray  # (m, m) int64

    def __post_init__(self) -> None:
        self.demand = np.asarray(self.demand, dtype=np.int64)
        if self.demand.ndim != 2 or self.demand.shape[0] != self.demand.shape[1]:
            raise ValueError(f"demand must be square, got {self.demand.shape}")
        if (self.demand < 0).any():
            raise ValueError("demands must be non-negative")

    @property
    def m(self) -> int:
        return self.demand.shape[0]

    @property
    def D(self) -> int:
        return effective_size(self.demand)


@dataclass
class Job:
    """A multi-stage job: coflows + Starts-After DAG + weight + release time."""

    jid: int
    coflows: list[Coflow]
    edges: list[tuple[int, int]]  # (a, b): coflow a precedes coflow b
    weight: float = 1.0
    release: int = 0

    def __post_init__(self) -> None:
        validate_dag(len(self.coflows), self.edges)

    @property
    def mu(self) -> int:
        return len(self.coflows)

    @property
    def m(self) -> int:
        return self.coflows[0].m if self.coflows else 0

    def aggregate_demand(self) -> np.ndarray:
        agg = np.zeros((self.m, self.m), dtype=np.int64)
        for c in self.coflows:
            agg += c.demand
        return agg

    @property
    def delta(self) -> int:
        """Aggregate size Δ_j (Definition 2)."""
        return effective_size(self.aggregate_demand())

    @property
    def T(self) -> int:
        """Critical path size T_j (Definition 3)."""
        return critical_path_size(self)

    def remap(self, jid: int) -> "Job":
        job = dataclasses.replace(self, jid=jid)
        job.coflows = [dataclasses.replace(c, jid=jid) for c in self.coflows]
        return job


@dataclass
class Instance:
    """A scheduling instance: a set of jobs over an m x m switch."""

    m: int
    jobs: list[Job]

    def __post_init__(self) -> None:
        for j in self.jobs:
            for c in j.coflows:
                if c.m != self.m:
                    raise ValueError("coflow port count mismatch with instance m")

    @property
    def n(self) -> int:
        return len(self.jobs)

    @property
    def mu(self) -> int:
        return max((j.mu for j in self.jobs), default=0)

    def delta(self) -> int:
        """Δ: aggregate size over all jobs (Definition 2)."""
        return aggregate_size(c.demand for j in self.jobs for c in j.coflows)

    def total_demand(self) -> int:
        return int(sum(int(c.demand.sum()) for j in self.jobs for c in j.coflows))

    def gamma(self) -> int:
        """γ = min positive flow size (paper §VI-B)."""
        vals = [int(c.demand[c.demand > 0].min()) for j in self.jobs for c in j.coflows
                if (c.demand > 0).any()]
        return min(vals) if vals else 1


def validate_dag(n: int, edges: Sequence[tuple[int, int]]) -> None:
    for a, b in edges:
        if not (0 <= a < n and 0 <= b < n) or a == b:
            raise ValueError(f"bad edge ({a},{b}) for {n} coflows")
    topological_order(n, edges)  # raises on cycles


def topological_order(n: int, edges: Sequence[tuple[int, int]]) -> list[int]:
    """Kahn topological sort; deterministic (smallest index first)."""
    indeg = [0] * n
    out: list[list[int]] = [[] for _ in range(n)]
    for a, b in edges:
        indeg[b] += 1
        out[a].append(b)
    import heapq

    heap = [i for i in range(n) if indeg[i] == 0]
    heapq.heapify(heap)
    order: list[int] = []
    while heap:
        u = heapq.heappop(heap)
        order.append(u)
        for v in out[u]:
            indeg[v] -= 1
            if indeg[v] == 0:
                heapq.heappush(heap, v)
    if len(order) != n:
        raise ValueError("dependency graph has a cycle")
    return order


def parents_of(n: int, edges: Sequence[tuple[int, int]]) -> list[list[int]]:
    par: list[list[int]] = [[] for _ in range(n)]
    for a, b in edges:
        par[b].append(a)
    return par


def children_of(n: int, edges: Sequence[tuple[int, int]]) -> list[list[int]]:
    ch: list[list[int]] = [[] for _ in range(n)]
    for a, b in edges:
        ch[a].append(b)
    return ch


def coflow_layers(job: Job) -> list[list[int]]:
    """Coflow sets S_0..S_{H-1} (Definition 6): S_i = nodes whose longest path
    from a source has length i."""
    n = job.mu
    par = parents_of(n, job.edges)
    order = topological_order(n, job.edges)
    depth = [0] * n
    for u in order:
        for p in par[u]:
            depth[u] = max(depth[u], depth[p] + 1)
    h = max(depth, default=-1) + 1
    layers: list[list[int]] = [[] for _ in range(h)]
    for u in range(n):
        layers[depth[u]].append(u)
    return layers


def critical_path_size(job: Job) -> int:
    """T_j (Definition 3): max over directed paths of the sum of effective sizes."""
    n = job.mu
    if n == 0:
        return 0
    par = parents_of(n, job.edges)
    order = topological_order(n, job.edges)
    sizes = [c.D for c in job.coflows]
    best = [0] * n
    for u in order:
        best[u] = sizes[u] + max((best[p] for p in par[u]), default=0)
    return max(best)


def is_rooted_forest(job: Job) -> bool:
    """True iff the DAG is a disjoint union of fan-in trees (every out-degree
    <= 1) or of fan-out trees (every in-degree <= 1).

    Strictly wider than `is_rooted_tree` (connectivity and the single-root
    requirement are dropped).  This is the class DMA-SRT's path machinery is
    actually safe on: maximal paths are one-per-source (fan-in) or
    one-per-sink (fan-out), so enumeration cannot blow up.  It matters
    online: removing completed coflows from a rooted tree preserves the
    degree bound but not connectivity, so residual sub-jobs at a
    rescheduling point are forests."""
    n = job.mu
    if n == 0:
        return False
    outdeg = [0] * n
    indeg = [0] * n
    for a, b in job.edges:
        outdeg[a] += 1
        indeg[b] += 1
    return all(d <= 1 for d in outdeg) or all(d <= 1 for d in indeg)


def is_rooted_tree(job: Job) -> bool:
    """True iff the DAG is a fan-in or fan-out rooted tree (Definition 5)."""
    n = job.mu
    if n == 0:
        return False
    if len(job.edges) != n - 1:
        return False
    outdeg = [0] * n
    indeg = [0] * n
    for a, b in job.edges:
        outdeg[a] += 1
        indeg[b] += 1
    # connectivity (undirected)
    adj: list[list[int]] = [[] for _ in range(n)]
    for a, b in job.edges:
        adj[a].append(b)
        adj[b].append(a)
    seen = [False] * n
    stack = [0]
    seen[0] = True
    cnt = 1
    while stack:
        u = stack.pop()
        for v in adj[u]:
            if not seen[v]:
                seen[v] = True
                cnt += 1
                stack.append(v)
    if cnt != n:
        return False
    fan_in = all(d <= 1 for d in outdeg) and sum(1 for d in outdeg if d == 0) == 1
    fan_out = all(d <= 1 for d in indeg) and sum(1 for d in indeg if d == 0) == 1
    return fan_in or fan_out

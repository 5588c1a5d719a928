"""Lemma 2 gap instance: a DAG job whose optimal makespan is
Omega(sqrt(mu) * (Delta + T)) — a sqrt(mu) factor above both simple lower
bounds. We build the paper's construction, its hand-crafted optimal-order
schedule, and expose the quantities for tests.

Construction (paper, 1-indexed; here 0-indexed): mu = (2K)^2 coflows in an
m x m switch, m > 2K. Level i in {0..2K-1} holds coflows i*2K .. (i+1)*2K-1,
each a single flow of size d from sender i to receiver i+1. Parents of
coflow c at level i >= 1:
  first half of the level  -> { c-2K .. c-K-1 }
  second half of the level -> { c-3K+1 .. c-2K }
Then T = Delta = 2Kd while C_opt = (2K+1)K d = Omega(mu d).
"""
from __future__ import annotations

import numpy as np

from .types import Coflow, Instance, Job

__all__ = ["gap_instance", "gap_optimal_schedule_length", "gap_bounds",
           "gap_hand_schedule"]


def gap_instance(K: int, d: int = 1, m: int | None = None) -> Instance:
    if m is None:
        m = 2 * K + 2
    assert m > 2 * K, "need m > 2K"
    mu = (2 * K) ** 2
    coflows: list[Coflow] = []
    for c in range(mu):
        level = c // (2 * K)
        dm = np.zeros((m, m), dtype=np.int64)
        dm[level, level + 1] = d
        coflows.append(Coflow(0, c, dm))
    edges: list[tuple[int, int]] = []
    for c in range(2 * K, mu):
        level = c // (2 * K)
        pos = c - level * 2 * K  # 0..2K-1 within the level
        if pos < K:  # first half: parents c-2K .. c-K-1
            lo, hi = c - 2 * K, c - K - 1
        else:        # second half: parents c-3K+1 .. c-2K
            lo, hi = c - 3 * K + 1, c - 2 * K
        for p in range(lo, hi + 1):
            edges.append((p, c))
    return Instance(m, [Job(0, coflows, edges, weight=1.0)])


def gap_optimal_schedule_length(K: int, d: int = 1) -> int:
    """(2K+1) K d — the hand schedule's makespan (paper's optimal order:
    K sequential coflows, then 2K-1 rounds of K simultaneous pairs, then K
    sequential)."""
    return (2 * K + 1) * K * d


def gap_bounds(inst: Instance) -> tuple[int, int]:
    """(Delta_j, T_j) of the gap job — both equal 2Kd by construction."""
    job = inst.jobs[0]
    return job.delta, job.T


def gap_hand_schedule(K: int, d: int = 1) -> list[tuple[int, list[int]]]:
    """The paper's explicit feasible schedule: list of (start, coflow ids run
    back-to-back... each tuple is a *round* of simultaneously-running coflows
    occupying [start, start + d)). Used by tests to check feasibility and the
    (2K+1)Kd makespan."""
    rounds: list[list[int]] = []
    # K initial coflows of level 0, sequential
    for c in range(K):
        rounds.append([c])
    # pairs: for i = 1..2K-1, c = 1..K: coflows 2(i-1/2)K + c and 2iK + c
    # (1-indexed) run together -> 0-indexed: (2i-1)K + c-1 and 2iK + c-1
    for i in range(1, 2 * K):
        for c in range(K):
            rounds.append([(2 * i - 1) * K + c, 2 * i * K + c])
    # last K coflows sequential
    for c in range(4 * K * K - K, 4 * K * K):
        rounds.append([c])
    return [(t * d, r) for t, r in enumerate(rounds)]

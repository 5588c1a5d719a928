"""Theorem 1 reduction: preemptive Flow Shop -> single rooted-tree coflow job.

FSP instance: n jobs x m machines, task i of job j needs p[i][j] time on
machine i, same machine order for all jobs. The constructed coflow job is a
fan-out tree: a dummy root coflow (one flow of size 1, sender 1 -> receiver
0), and n branches of m coflows each; branch j level l (0-indexed levels
1..m-1 of the tree) has one flow sender l-1 -> receiver l of size p[l-1][j],
and the final level a flow sender m-1 -> receiver 0 of size p[m-1][j].
An optimal makespan for the coflow job gives an optimal preemptive FSP
makespan after dropping the dummy's first time unit.
"""
from __future__ import annotations

import numpy as np

from .types import Coflow, Instance, Job

__all__ = ["fsp_to_coflow_job"]


def fsp_to_coflow_job(p: np.ndarray) -> Instance:
    """p: (m_machines, n_jobs) positive processing times."""
    p = np.asarray(p, dtype=np.int64)
    m_mach, n = p.shape
    assert (p > 0).all()
    ports = max(m_mach, 2)
    coflows: list[Coflow] = []
    edges: list[tuple[int, int]] = []

    def flow(s: int, r: int, size: int) -> np.ndarray:
        d = np.zeros((ports, ports), dtype=np.int64)
        d[s, r] = size
        return d

    coflows.append(Coflow(0, 0, flow(1, 0, 1)))  # dummy root
    cid = 1
    for j in range(n):
        prev = 0  # root
        for l in range(m_mach):
            if l < m_mach - 1:
                d = flow(l, l + 1, int(p[l, j]))
            else:
                d = flow(m_mach - 1, 0, int(p[l, j]))
            coflows.append(Coflow(0, cid, d))
            edges.append((prev, cid))
            prev = cid
            cid += 1
    return Instance(ports, [Job(0, coflows, edges, weight=1.0)])

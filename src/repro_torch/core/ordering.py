"""Combinatorial primal-dual job ordering (paper Algorithm 5, Appendix A).

Builds the permutation in reverse: at step k, if the unscheduled job with
the largest T_j + rho_j exceeds the current max server load d_phi, it goes
last (its dual eta_j is raised until constraint (21b) is tight); otherwise
the job minimizing residual-weight / load-on-phi goes last (raising
lambda_{phi, N'}). Runs in O(n(n + m)) here (paper: O(n(log n + m)) with
heaps; n is small in all our workloads).

Returns the permutation sigma (front-to-back) plus the dual variables so
tests can check dual feasibility (residual weights stay >= 0, Lemma 9).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import torch

from .types import Instance, Job

__all__ = ["job_order", "cached_job_order", "OrderResult",
           "job_load_vectors", "instance_signature"]


@dataclass
class OrderResult:
    order: list[int]            # job ids, first-to-last
    eta: dict[int, float]       # eta_j duals
    lambdas: list[tuple[int, int, float]]  # (server index in 0..2m-1, k, lambda value)
    residual: dict[int, float]  # residual weights at removal time (>= 0 iff dual-feasible)


def job_load_vectors(jobs: list[Job], m: int) -> np.ndarray:
    """d_i^j for i in M_S + M_R: (n, 2m) aggregate-coflow loads per job.

    Each job's row is memoized on (m, per-coflow demand bytes) in the
    backend's bounded loads LRU — untouched jobs hit across online
    replans even though ``sub_instance`` rebuilds fresh Job objects every
    arrival (the BNA cache's key discipline).  Rows are assembled into a
    fresh array, so callers may mutate the result."""
    from . import backend

    n = len(jobs)
    d = np.zeros((n, 2 * m), dtype=np.float64)
    for k, j in enumerate(jobs):
        key = (m, tuple((c.demand.shape, c.demand.dtype.str,
                         c.demand.tobytes()) for c in j.coflows))
        found, row = backend.loads_cache.lookup(key)
        if not found:
            agg = j.aggregate_demand()
            row = np.concatenate([agg.sum(axis=1), agg.sum(axis=0)]) \
                .astype(np.float64)
            backend.loads_cache.store(key, row)
        d[k] = row
    return d


def job_order(instance: Instance, loads: np.ndarray | None = None) -> OrderResult:
    """loads: optional precomputed job_load_vectors (n, 2m) float64."""
    jobs = instance.jobs
    n = len(jobs)
    m = instance.m
    if n == 0:
        return OrderResult([], {}, [], {})
    d = loads if loads is not None else job_load_vectors(jobs, m)  # (n, 2m)
    key = np.array([j.T + j.release for j in jobs], dtype=np.float64)
    wres = np.array([j.weight for j in jobs], dtype=np.float64)
    alive = np.ones(n, dtype=bool)
    loads = d.sum(axis=0)                    # current d_i over N'
    sigma: list[int] = [0] * n
    eta: dict[int, float] = {}
    lambdas: list[tuple[int, int, float]] = []
    residual: dict[int, float] = {}

    for k in range(n - 1, -1, -1):
        phi = int(np.argmax(loads))
        d_phi = loads[phi]
        cand = np.flatnonzero(alive)
        j = int(cand[np.argmax(key[cand])])
        if key[j] > d_phi:
            eta[jobs[j].jid] = float(wres[j])
            residual[jobs[j].jid] = float(wres[j])
            pick = j
        else:
            loads_phi = d[cand, phi]
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio = np.where(loads_phi > 0, wres[cand] / loads_phi, np.inf)
            jp = int(cand[np.argmin(ratio)])
            lam = float(wres[jp] / d[jp, phi]) if d[jp, phi] > 0 else 0.0
            lambdas.append((phi, k, lam))
            wres[cand] = wres[cand] - lam * d[cand, phi]
            residual[jobs[jp].jid] = float(wres[jp])
            pick = jp
        sigma[k] = pick
        alive[pick] = False
        loads -= d[pick]

    return OrderResult([jobs[i].jid for i in sigma], eta, lambdas, residual)


def instance_signature(instance: Instance) -> tuple:
    """Hashable exact-state key: the full input Algorithm 5 reads.

    Two instances with equal signatures get identical orders, so caching on
    it is results-identical by construction.  Demands enter as raw bytes —
    the same key discipline as the BNA cache (backend.py)."""
    return (instance.m,) + tuple(
        (j.jid, float(j.weight), int(j.release), tuple(j.edges),
         tuple(c.demand.tobytes() for c in j.coflows))
        for j in instance.jobs)


def cached_job_order(instance: Instance, plan_backend: "str | None" = None,
                     device: "str | torch.device" = "cuda") -> OrderResult:
    """job_order memoized on the exact scheduling state (bounded LRU).

    Hits whenever the same state is re-planned: the G-DM vs O(m)Alg A/B
    pairs in the benchmarks, beta sweeps over one instance, and online
    reschedules whose active set only shrank with every surviving job's
    remaining demand untouched.  Returns a fresh copy so callers may
    mutate the order list safely.  A miss under the ``"pipeline"`` plan
    backend takes its load vectors from the device segment sum
    (``backend.plan_order_loads``), the same integers."""
    from . import backend

    key = instance_signature(instance)
    found, res = backend.order_cache.lookup(key)
    if not found:
        res = job_order(instance, loads=backend.plan_order_loads(
            instance, plan_backend, device))
        backend.order_cache.store(key, res)
    return OrderResult(list(res.order), dict(res.eta), list(res.lambdas),
                       dict(res.residual))

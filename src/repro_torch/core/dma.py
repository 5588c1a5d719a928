"""DMA — Delay-and-Merge Algorithm for general DAG jobs (paper Algorithm 2).

Step 1: per job, topologically sort its coflows and schedule them
        back-to-back, each optimally via BNA (the *isolated* schedule).
Step 2: delay each isolated schedule by an integer chosen uniformly at
        random in [0, Delta/beta], beta > 1/e.
Steps 3-4: merge the delayed schedules and expand to feasibility
        (merge_and_fix, Lemma 6).
"""
from __future__ import annotations

import numpy as np
import torch

from .backend import bna_pieces, plan_edges
from .timeline import (EdgeIntervals, FinalSchedule, UnitSchedule,
                       merge_and_fix, unit_from_coflow_edges,
                       unit_from_coflow_plan)
from .types import Job, aggregate_size, topological_order

__all__ = ["isolated_job_unit", "draw_delays", "dma", "coflow_unit",
           "check_delays_mode"]

_DELAY_MODES = ("random", "spread")


def check_delays_mode(delays: str) -> None:
    """Validate a Step 2 delay mode: "random" is the paper's randomized
    draw; "spread" is the deterministic evenly-spaced mode
    (draw_delays(rng=None), the §IV-C de-randomization stand-in) that the
    registry exposes as ``make_scheduler("gdm", delays="spread")``."""
    if delays not in _DELAY_MODES:
        raise ValueError(f"unknown delays mode {delays!r}; "
                         f"expected one of {_DELAY_MODES}")


def coflow_unit(jid: int, cid: int, demand: np.ndarray, start: int,
                device: "str | torch.device" = "cuda",
                plan_backend: "str | None" = None) -> UnitSchedule:
    """UnitSchedule for one coflow, via the plan backend: the pipeline
    serves cached start-relative edge intervals (``backend.plan_edges`` →
    ``core/pipeline.py``, bit-identical to the python RLE); the python
    path fetches the BNA pieces (memoized on the demand's bytes in the
    backend's LRU, which the engine's batched prefetch warms) and
    RLE-compresses them from `start`.  A miss decomposes on `device`."""
    rel = plan_edges(demand, plan_backend, device)
    if rel is not None:
        return unit_from_coflow_edges(jid, cid, demand, rel, start)
    return unit_from_coflow_plan(jid, cid, demand,
                                 bna_pieces(demand, device=device), start)


def isolated_job_unit(job: Job, start: int = 0,
                      device: "str | torch.device" = "cuda",
                      plan_backend: "str | None" = None) -> UnitSchedule:
    """Step 1: feasible isolated schedule — coflows back-to-back in
    topological order, each scheduled optimally by BNA (Lemma 1)."""
    order = topological_order(job.mu, job.edges)
    t = start
    parts: list[UnitSchedule] = []
    for cid in order:
        c = job.coflows[cid]
        u = coflow_unit(job.jid, cid, c.demand, t, device=device,
                        plan_backend=plan_backend)
        parts.append(u)
        t += c.D
    edges = EdgeIntervals.concat([p.edges for p in parts]).with_owner(job.jid)
    ledger = [e for p in parts for e in p.ledger]
    return UnitSchedule(uid=job.jid, edges=edges, ledger=ledger)


def draw_delays(
    uids: list[int], delta: int, beta: float, rng: np.random.Generator | None,
) -> dict[int, int]:
    """Step 2 delays: uniform integers in [0, Delta/beta]. rng=None selects
    the deterministic 'spread' mode (evenly spaced — a practical stand-in for
    the de-randomization of §IV-C; documented, off by default)."""
    hi = int(delta // beta)
    if rng is None:
        k = max(len(uids), 1)
        return {uid: (i * hi) // max(k - 1, 1) if k > 1 else 0
                for i, uid in enumerate(uids)}
    return {uid: int(rng.integers(0, hi + 1)) for uid in uids}


def dma(
    jobs: list[Job],
    m: int,
    beta: float = 2.0,
    rng: np.random.Generator | None = None,
    origin: int = 0,
    decompose: bool = False,
    delays: str = "random",
    device: "str | torch.device" = "cuda",
    plan_backend: "str | None" = None,
) -> FinalSchedule:
    """Schedule a set of general-DAG jobs; makespan O(mu * g(m)) x OPT whp
    (Theorem 2).  delays="spread" selects the deterministic evenly-spaced
    Step 2 delays (see check_delays_mode); `device` and `plan_backend` are
    where and how the coflows are decomposed and merged."""
    check_delays_mode(delays)
    if rng is None:
        rng = np.random.default_rng(0)
    units = [isolated_job_unit(j, device=device, plan_backend=plan_backend)
             for j in jobs]
    delta = aggregate_size(c.demand for j in jobs for c in j.coflows)
    delay_map = draw_delays([j.jid for j in jobs], delta, beta,
                            None if delays == "spread" else rng)
    return merge_and_fix(units, m, delay_map, origin=origin,
                         decompose=decompose, device=device,
                         plan_backend=plan_backend)

"""DMA-SRT and DMA-RT — rooted-tree jobs (paper Algorithm 3 and §V-B).

DMA-SRT (single rooted tree):
  1. Enumerate path sub-jobs P_j (maximal source->sink directed paths; for a
     fan-in tree, one per leaf). Draw a random delay d_p in [0, Delta_j/beta]
     per path; the start of coflow c according to p is
     t_{c,p} = d_p + sum of effective sizes of c's predecessors on p.
  2. Sweep coflow sets S_0..S_{H-1}; each coflow starts at the smallest
     t_{c,p} that is >= every parent's finish time.
  3. Schedule each coflow by BNA at its start time.
  4-5. merge_and_fix (DMA Steps 3-4).

DMA-RT (multiple rooted trees): run DMA-SRT per job (with packet-level
decomposition so each job's schedule is a sequence of timed matchings, as
DMA Step 3 requires), then delay each whole job schedule uniformly in
[0, Delta/beta], merge, and fix.
"""
from __future__ import annotations

import numpy as np
import torch

from .dma import check_delays_mode, coflow_unit, draw_delays
from .timeline import FinalSchedule, UnitSchedule, merge_and_fix
from .types import (Job, aggregate_size, children_of, coflow_layers,
                    is_rooted_forest, parents_of)

__all__ = ["path_subjobs", "srt_start_times", "dma_srt", "dma_rt"]


def path_subjobs(job: Job, max_paths: int | None = None) -> list[list[int]]:
    """Maximal directed source->sink paths. For a rooted tree this is the
    paper's P_j (|P_j| <= mu). A cap guards accidental use on dense DAGs."""
    n = job.mu
    ch = children_of(n, job.edges)
    indeg = [0] * n
    for _, b in job.edges:
        indeg[b] += 1
    sources = [i for i in range(n) if indeg[i] == 0]
    paths: list[list[int]] = []
    cap = max_paths if max_paths is not None else 4 * max(n, 1)
    stack: list[list[int]] = [[s] for s in reversed(sources)]
    while stack:
        p = stack.pop()
        u = p[-1]
        if not ch[u]:
            paths.append(p)
            if len(paths) > cap:
                raise ValueError("too many paths; DMA-SRT expects a rooted tree")
            continue
        for v in ch[u]:
            stack.append(p + [v])
    return paths


def srt_start_times(
    job: Job, beta: float, rng: np.random.Generator | None,
    require_tree: bool = True,
) -> list[int]:
    """Steps 1-2 of Algorithm 3: per-coflow start times t_c.

    If no path candidate clears the precedence bound (possible only for
    fan-out orientations / non-tree inputs), falls back to starting right
    after the parents finish — precedence always holds; only the analysis
    constant is affected (documented in DESIGN.md).

    Accepted shapes are rooted *forests* (disjoint unions of fan-in or of
    fan-out trees) — strictly wider than the paper's Definition 5 trees,
    because online rescheduling hands DMA-SRT the residual of a tree after
    completed coflows are removed, and that residual loses connectivity but
    never the degree bound.  Path enumeration stays linear on forests.

    General DAGs with require_tree=False skip path enumeration entirely
    (a dense DAG can have exponentially many maximal paths) and use the
    start-after-parents fallback for every coflow — this is what lets the
    scenario x scheduler cross-product run G-DM-RT on general-DAG
    workloads."""
    n = job.mu
    sizes = [c.D for c in job.coflows]
    if not is_rooted_forest(job):
        if require_tree:
            raise ValueError(f"job {job.jid} is not a rooted tree or forest")
        par = parents_of(n, job.edges)
        t: list[int] = [0] * n
        for layer in coflow_layers(job):
            for c in layer:
                t[c] = max((t[q] + sizes[q] for q in par[c]), default=0)
        return t
    paths = path_subjobs(job)
    delta_j = job.delta
    hi = int(delta_j // beta)
    if rng is None:
        d_p = [(i * hi) // max(len(paths) - 1, 1) if len(paths) > 1 else 0
               for i in range(len(paths))]
    else:
        d_p = [int(rng.integers(0, hi + 1)) for _ in paths]

    cand: list[list[int]] = [[] for _ in range(n)]
    for p, dp in zip(paths, d_p):
        acc = dp
        for c in p:
            cand[c].append(acc)
            acc += sizes[c]

    par = parents_of(n, job.edges)
    t: list[int] = [0] * n
    for layer in coflow_layers(job):
        for c in layer:
            bound = max((t[q] + sizes[q] for q in par[c]), default=0)
            feas = [x for x in cand[c] if x >= bound]
            t[c] = min(feas) if feas else bound
    return t


def dma_srt(
    job: Job,
    m: int,
    beta: float = 2.0,
    rng: np.random.Generator | None = None,
    origin: int = 0,
    decompose: bool = True,
    require_tree: bool = True,
    delays: str = "random",
    device: "str | torch.device" = "cuda",
    plan_backend: "str | None" = None,
) -> FinalSchedule:
    """Single rooted-tree job; makespan O(sqrt(mu) * h(m, mu)) x OPT whp
    (Theorem 3).  delays="spread" de-randomizes the per-path delays
    (srt_start_times with rng=None)."""
    check_delays_mode(delays)
    starts = srt_start_times(job, beta,
                             None if delays == "spread" else rng,
                             require_tree=require_tree)
    units: list[UnitSchedule] = []
    for cid, c in enumerate(job.coflows):
        units.append(coflow_unit(job.jid, cid, c.demand, starts[cid],
                                 device=device, plan_backend=plan_backend))
        units[-1].uid = cid
    return merge_and_fix(units, m, origin=origin, decompose=decompose,
                         device=device, plan_backend=plan_backend)


def dma_rt(
    jobs: list[Job],
    m: int,
    beta: float = 2.0,
    rng: np.random.Generator | None = None,
    origin: int = 0,
    decompose: bool = False,
    require_tree: bool = True,
    nested: bool = True,
    delays: str = "random",
    device: "str | torch.device" = "cuda",
    plan_backend: "str | None" = None,
) -> FinalSchedule:
    """Multiple rooted-tree jobs; makespan O(sqrt(mu) g(m) h(m, mu)) x OPT
    whp (Theorem 4).

    nested=True is the paper's exact construction: a full DMA-SRT (with its
    own packet-level fix-up) per job, then delay/merge/fix across jobs.
    nested=False is the flat fast path: per-path start times within jobs
    (DMA-SRT Steps 1-2) + per-job delays, ONE global merge-and-fix — the
    same randomized-delay/merge principle with a single expansion; used by
    the large benchmark sweeps (tests check both are feasible and close).

    delays="spread" de-randomizes both delay layers (per-path start times
    and per-job delays)."""
    check_delays_mode(delays)
    if rng is None:
        rng = np.random.default_rng(0)
    if nested:
        units = [
            dma_srt(j, m, beta, rng, decompose=True,
                    require_tree=require_tree, delays=delays,
                    device=device, plan_backend=plan_backend).to_unit(j.jid)
            for j in jobs
        ]
    else:
        from .timeline import EdgeIntervals
        units = []
        for j in jobs:
            starts = srt_start_times(j, beta,
                                     None if delays == "spread" else rng,
                                     require_tree=require_tree)
            parts = [coflow_unit(j.jid, cid, c.demand, starts[cid],
                                 device=device, plan_backend=plan_backend)
                     for cid, c in enumerate(j.coflows)]
            edges = EdgeIntervals.concat([p.edges for p in parts]).with_owner(j.jid)
            units.append(UnitSchedule(
                uid=j.jid, edges=edges,
                ledger=[e for p in parts for e in p.ledger]))
    delta = aggregate_size(c.demand for j in jobs for c in j.coflows)
    delay_map = draw_delays([j.jid for j in jobs], delta, beta,
                            None if delays == "spread" else rng)
    return merge_and_fix(units, m, delay_map, origin=origin,
                         decompose=decompose, device=device,
                         plan_backend=plan_backend)

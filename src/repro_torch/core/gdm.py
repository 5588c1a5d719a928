"""G-DM and G-DM-RT — total weighted completion time minimization
(paper Algorithm 4, §VI).

1. Order jobs with the combinatorial primal-dual Algorithm 5.
2. D_j = effective size of the aggregate coflow of the first j jobs in that
   order; T_j = critical path size; rho_j = release time.
3. Partition jobs into groups J_b by which geometric interval
   (gamma 2^{b-1}, gamma 2^b] contains T_j + rho_j + D_j.
4. Schedule the groups in order; group b starts once the previous group is
   done AND all its jobs have arrived; each group is scheduled by DMA
   (general DAGs) or DMA-RT (rooted trees).

Approximation: O(mu g(m)) for general DAGs (Theorem 5);
O(sqrt(mu) g(m) h(m, mu)) for rooted trees (Corollary 1).

``gdm(..., gamma=...)`` accepts an externally pinned gamma, as in the
reference; the session-side pinning policy (``GammaEpoch``) comes with the
port of the session.
"""
from __future__ import annotations

import dataclasses
import math
from fractions import Fraction

import numpy as np
import torch

from .ordering import cached_job_order
from .result import CompositeSchedule
from .types import Instance

__all__ = ["gdm", "group_jobs", "geometric_bucket"]


def geometric_bucket(key: int, gamma) -> int:
    """Smallest b >= 0 with key <= gamma * 2^b, exactly: for gamma = p/q
    the condition is 2^b >= ceil(q*key / p), and the smallest power of two
    at or above a positive integer x is ``(x - 1).bit_length()`` — all
    integer arithmetic, no float log, no guard loops."""
    if key <= 0:
        return 0
    g = Fraction(gamma)
    return ((g.denominator * int(key) - 1) // g.numerator).bit_length()


def group_jobs(instance: Instance, order: list[int],
               gamma=None) -> list[list[int]]:
    """Steps 2-3: geometric grouping by T_j + rho_j + D_j (prefix aggregate).

    ``gamma`` defaults to the instance's natural gamma (min positive flow
    size, the paper's definition); a caller may pin it across replans so
    bucket boundaries — and group memberships — stay stable.  Accepts any
    positive int/Fraction.  The prefix effective sizes come from the backend's
    memoized cumsum (``grouping_prefix``), which extends a cached prefix
    for appended arrivals instead of recomputing.

    Returns groups as lists of job ids, in increasing b; empty groups are
    dropped (they contribute nothing to the schedule)."""
    from . import backend

    by_id = {j.jid: j for j in instance.jobs}
    if gamma is None:
        gamma = instance.gamma()
    g = Fraction(gamma)
    if g <= 0:
        raise ValueError(f"gamma must be positive, got {gamma!r}")
    D = backend.grouping_prefix(instance, order)
    groups: dict[int, list[int]] = {}
    for i, jid in enumerate(order):
        job = by_id[jid]
        key = job.T + job.release + int(D[i])
        groups.setdefault(geometric_bucket(key, g), []).append(jid)
    return [groups[b] for b in sorted(groups)]


def gdm(
    instance: Instance,
    beta: float = 2.0,
    rng: np.random.Generator | None = None,
    rooted: bool = False,
    decompose: bool = False,
    nested: bool = True,
    require_tree: bool = True,
    delays: str = "random",
    gamma=None,
    device: "str | torch.device" = "cuda",
    plan_backend: "str | None" = None,
) -> CompositeSchedule:
    """G-DM (rooted=False) / G-DM-RT (rooted=True).

    require_tree=False lets G-DM-RT accept non-tree jobs: DMA-SRT's start
    times fall back to start-after-parents for those jobs (precedence-exact;
    only the rooted-tree analysis constant is lost).

    delays="spread" selects the deterministic evenly-spaced Step 2 delays
    (dma.draw_delays with rng=None): the plan becomes rng-independent, and
    the per-group layouts are assembled from the backend's group-block
    cache — each group is built once at origin 0 and slid to its chain
    position (``FinalSchedule.shifted_expanded``), bit-identical to direct
    construction by translation invariance.

    ``gamma`` overrides the geometric-grouping scale (None: the instance's
    natural gamma); the grouping analysis holds up to the pin's bounded
    ratio.

    ``device`` and ``plan_backend`` are where and how the coflows are
    decomposed and every merge_and_fix computes its alphas."""
    from .dma import check_delays_mode, dma
    from .dma_srt import dma_rt

    check_delays_mode(delays)
    if rng is None:
        rng = np.random.default_rng(0)
    by_id = {j.jid: j for j in instance.jobs}
    res = cached_job_order(instance, plan_backend=plan_backend,
                           device=device)
    eff_gamma = Fraction(gamma) if gamma is not None \
        else Fraction(instance.gamma())
    groups = group_jobs(instance, res.order, gamma=eff_gamma)
    kind = "gdm_rt" if rooted else "gdm"
    parts = []
    t_cur = 0
    for g in groups:
        jobs = [by_id[jid] for jid in g]
        start = max(t_cur, max((j.release for j in jobs), default=0))
        if delays == "spread":
            from . import backend

            sub = backend.group_block(
                kind, jobs, instance.m, beta=beta, decompose=decompose,
                nested=nested, require_tree=require_tree, delays=delays,
                device=device, plan_backend=plan_backend
            ).shifted_expanded(int(start))
            # the cached block may have been built by a plan on another
            # device or plan backend: a lazy fix-up runs on this plan's
            sub = dataclasses.replace(
                sub, device=torch.device(device),
                plan_backend=backend.resolve_plan_backend(plan_backend,
                                                          device))
        elif rooted:
            sub = dma_rt(jobs, instance.m, beta=beta, rng=rng,
                         origin=int(start), decompose=decompose,
                         nested=nested, require_tree=require_tree,
                         delays=delays, device=device,
                         plan_backend=plan_backend)
        else:
            sub = dma(jobs, instance.m, beta=beta, rng=rng,
                      origin=int(start), decompose=decompose,
                      delays=delays, device=device,
                      plan_backend=plan_backend)
        parts.append(sub)
        t_cur = int(math.ceil(sub.makespan))
    return CompositeSchedule(parts, instance, meta={
        "order": res.order, "groups": groups,
        "algorithm": "G-DM-RT" if rooted else "G-DM",
        "beta": beta, "gamma": eff_gamma,
    })

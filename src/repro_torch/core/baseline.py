"""O(m)Alg — the prior state-of-the-art baseline (Tian et al. [5], [11]).

Their algorithm orders jobs via an LP over ordering variables, then
schedules jobs ONE AT A TIME: each job's coflows run sequentially in
topological order, each coflow scheduled optimally (BNA), with no
interleaving across jobs — the paper identifies exactly this
one-at-a-time behaviour as the reason for the O(m) loss.

No LP solver ships in this environment, so the LP ordering is replaced by
the combinatorial Algorithm 5 ordering — a feasible dual solution for the
SAME relaxation LP (3) (this substitution is documented in DESIGN.md and
EXPERIMENTS.md). This isolates the comparison to the scheduling policy
(one-at-a-time vs delay-and-merge), which is the effect the paper measures.
"""
from __future__ import annotations

import torch

from .dma import isolated_job_unit
from .ordering import cached_job_order
from .result import CompositeSchedule
from .timeline import merge_and_fix
from .types import Instance

__all__ = ["om_alg"]


def om_alg(instance: Instance, decompose: bool = False,
           device: "str | torch.device" = "cuda",
           plan_backend: "str | None" = None) -> CompositeSchedule:
    by_id = {j.jid: j for j in instance.jobs}
    res = cached_job_order(instance, plan_backend=plan_backend,
                           device=device)
    units = []
    delays: dict[int, int] = {}
    t = 0
    for jid in res.order:
        job = by_id[jid]
        start = max(t, int(job.release))
        units.append(isolated_job_unit(job, start=start, device=device,
                                       plan_backend=plan_backend))
        t = start + sum(c.D for c in job.coflows)
    # jobs never overlap -> every merged interval has alpha <= 1 and the
    # "expansion" is the identity; merge_and_fix just assembles accounting.
    sched = merge_and_fix(units, instance.m, delays, origin=0,
                          decompose=decompose, device=device,
                          plan_backend=plan_backend)
    assert (sched.alphas <= 1).all(), "O(m)Alg sub-schedules must not overlap"
    return CompositeSchedule([sched], instance, meta={
        "order": res.order, "algorithm": "O(m)Alg",
    })

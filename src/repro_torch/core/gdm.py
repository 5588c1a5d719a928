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

Pinned gamma (session-stable grouping)
--------------------------------------
The paper's gamma is the min positive flow size of the *instance*; in the
online protocol the residual instance changes on every arrival, so the
bucket boundaries — and with them group memberships — drift on nearly
every replan, defeating the session's block-granular plan reuse.
``group_jobs(..., gamma=...)`` therefore accepts an externally pinned
gamma, and :class:`GammaEpoch` is the session-side policy that owns it:
pin to the first residual's natural gamma, then rescale **monotonically
downward by powers of two** only when a later residual's natural gamma
drops below the pin (natural >= pinned keeps the pin — the factor-2 band
is one-sided because residual minima only matter downward: a gamma
*smaller* than natural just splits the geometric intervals finer, which
preserves the grouping analysis up to the bounded ratio, while a gamma
above natural would break the (gamma 2^{b-1}, gamma 2^b] covering).
Under heavy-tail traces the natural residual gamma oscillates between 1
and the smallest undrained flow; the monotone pin converges (typically to
1) and then never moves, making group membership a stable function of the
residual jobs — the lever that turns most replans into reassemblies of
cached group blocks (``backend.group_block``).  Rescale counts surface in
``SessionStats.gamma_rescales``.
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

__all__ = ["gdm", "group_jobs", "GammaEpoch", "geometric_bucket"]


class GammaEpoch:
    """The session's pinned gamma (module docstring): power-of-two
    monotone-downward rescales, exact ``Fraction`` arithmetic (halving an
    odd natural gamma leaves the integers — the bucket computation stays
    exact on rationals).  ``fixed=True`` freezes the pin (an explicit
    numeric ``gamma=`` on the session).  ``state()`` round-trips through
    :class:`~repro_torch.core.session.SessionSnapshot` for kill-and-resume."""

    def __init__(self, pinned: "Fraction | None" = None, rescales: int = 0,
                 fixed: bool = False):
        if pinned is not None:
            pinned = Fraction(pinned)
            if pinned <= 0:
                raise ValueError(f"pinned gamma must be positive, "
                                 f"got {pinned}")
        self.pinned = pinned
        self.rescales = int(rescales)
        self.fixed = bool(fixed)

    def observe(self, natural: int) -> Fraction:
        """Fold one planning event's natural residual gamma into the pin
        and return the gamma to plan with."""
        if natural <= 0:
            raise ValueError(f"natural gamma must be positive, "
                             f"got {natural}")
        if self.fixed:
            return self.pinned
        if self.pinned is None:
            self.pinned = Fraction(natural)
            return self.pinned
        while self.pinned > natural:
            self.pinned /= 2
            self.rescales += 1
        return self.pinned

    def state(self) -> tuple:
        """(numerator, denominator, rescales, fixed) — or None-pinned as
        (0, 1, rescales, fixed)."""
        num = self.pinned.numerator if self.pinned is not None else 0
        den = self.pinned.denominator if self.pinned is not None else 1
        return (num, den, self.rescales, self.fixed)

    @classmethod
    def from_state(cls, state: tuple) -> "GammaEpoch":
        num, den, rescales, fixed = state
        pinned = Fraction(num, den) if num else None
        return cls(pinned=pinned, rescales=rescales, fixed=fixed)

    @classmethod
    def from_policy(cls, gamma) -> "GammaEpoch | None":
        """Map the session-level ``gamma=`` policy value to an epoch:
        ``"residual"`` -> None (the paper's per-plan natural gamma),
        ``"pinned"`` -> fresh adaptive epoch, positive int/Fraction ->
        fixed pin.  Shared by
        :class:`~repro_torch.core.session.SchedulerSession` and
        ``simulate_online``'s batch driver so the two validate — and pin —
        identically."""
        if gamma == "residual":
            return None
        if gamma == "pinned":
            return cls()
        if isinstance(gamma, (int, Fraction)) \
                and not isinstance(gamma, bool) and gamma > 0:
            return cls(pinned=Fraction(gamma), fixed=True)
        raise ValueError(f"gamma must be 'residual', 'pinned', or a "
                         f"positive int/Fraction, got {gamma!r}")

    def __repr__(self) -> str:
        return (f"GammaEpoch(pinned={self.pinned}, "
                f"rescales={self.rescales}, fixed={self.fixed})")


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

"""Coflow collective planner: schedule a training step's collectives with
the paper's engine (``repro.dist.planner`` on the port's session).

  1. A step's collective program is a list of :class:`CollectiveOp` in
     program order: kind, payload bytes, and the mesh axis its groups span
     ("model" = the minor axis, consecutive device ids; "data" = strided).
     `record_collectives(mesh)` records the one a step run on a DTensor
     mesh issues (dispatch order); `extract_collectives(hlo)` parses the
     reference's compiled XLA HLO text; `synthetic_collective_ops` makes a
     seeded one when no step is at hand.
  2. `coflows_from_step(ops, rows, cols, n_buckets)` translates it to a
     coflow Instance on the rows x cols pod fabric: ops are bucketed into
     jobs (contiguous program order, one job per gradient bucket); each op
     becomes one coflow whose demand matrix is the op's traffic pattern
     (ring over the axis its groups span; all-to-all is dense within
     groups); program order within a bucket becomes Starts-After edges.
  3. `plan(inst, device=...)` submits the bucket jobs to a live
     `repro_torch.core.session.SchedulerSession` on that device, drains it
     under G-DM, and compares with the naive program-order one-at-a-time
     makespan.
  4. `bucket_order_from_plan(res, leaf_paths)` translates the planned job
     permutation back into gradient-bucket launch order.
"""
from __future__ import annotations

import re
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..core.types import Coflow, Instance, Job

__all__ = ["CollectiveOp", "extract_collectives", "CollectiveRecorder",
           "record_collectives", "coflows_from_step",
           "synthetic_collective_ops", "plan", "PlanOutcome",
           "bucket_order_from_plan"]

_BYTES_PER_UNIT = float(2 ** 20)   # one demand unit == 1 MiB on the fabric

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_OP_RE = re.compile(
    r"=\s*([a-z0-9]+)\[([0-9,]*)\]\S*\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?(?:\.\d+)?\(")
_GROUPS_RE = re.compile(r"replica_groups=\{\{([0-9,]+)\}")


@dataclass
class CollectiveOp:
    """One collective in program order: kind, payload bytes, index, and the
    mesh axis its replica groups span ("model" = minor/consecutive ids)."""

    kind: str
    bytes: float
    idx: int
    axis: str = "model"


def extract_collectives(hlo_text: str) -> list[CollectiveOp]:
    """Collectives of a compiled (post-SPMD) XLA HLO module, program order:
    the reference's text parser, kept as it is (kind, the result's bytes,
    and "model" when the first replica group's ids are consecutive)."""
    ops: list[CollectiveOp] = []
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        dtype, dims, kind = m.group(1), m.group(2), m.group(3)
        numel = int(np.prod([int(d) for d in dims.split(",")])) if dims else 1
        nbytes = float(numel * _DTYPE_BYTES.get(dtype, 4))
        axis = "model"
        g = _GROUPS_RE.search(line)
        if g:
            ids = [int(x) for x in g.group(1).split(",")]
            consecutive = all(b - a == 1 for a, b in zip(ids, ids[1:]))
            axis = "model" if consecutive or len(ids) < 2 else "data"
        ops.append(CollectiveOp(kind, nbytes, len(ops), axis))
    return ops


# the functional collectives DTensor issues, by the kind the planner knows
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",   # DTensor's Shard(i) -> Shard(j)
}
# ops of the collective namespaces that move nothing
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d",
                          "_dtensor")


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor

    return issubclass(t, DTensor)


def _is_fake(x) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(x, FakeTensor)


class CollectiveRecorder(TorchDispatchMode):
    """The collectives a step issues on a DTensor mesh, as the reference's
    ``extract_collectives`` reads them from HLO: a ``TorchDispatchMode``
    that stands below DTensor's dispatch (it declines every op on a
    DTensor, so DTensor runs it and the mode sees the local ops and the
    functional collectives of its redistributions) and appends one
    :class:`CollectiveOp` a collective, in dispatch order:

    * kind: ``all_reduce`` -> "all-reduce", ``all_gather_into_tensor`` ->
      "all-gather", ``reduce_scatter_tensor`` -> "reduce-scatter",
      ``all_to_all_single`` -> "all-to-all"; any other collective raises;
    * bytes: the result's local numel times its element size (the
      reference's convention: the result tensor of the post-SPMD op);
    * axis: "model" when the op's group is the mesh's "model" dim, "data"
      for any other (the reference's consecutive-ids rule read from the
      mesh, not from replica groups).

    DTensor's sharding propagation runs ops on fake tensors of the global
    shapes to learn output shapes; those are not the step's and are
    skipped.  Subclasses see every local op through ``observe``."""

    def __init__(self, mesh):
        super().__init__()
        self.ops: list[CollectiveOp] = []
        names = tuple(mesh.mesh_dim_names or ())
        self.model_group = (mesh.get_group("model").group_name
                            if "model" in names else None)

    def _record(self, func, args, kwargs, out) -> None:
        name = func._opname
        if name in _NOT_COLLECTIVES:
            return
        kind = COLLECTIVE_KINDS.get(name)
        if kind is None:
            raise ValueError(f"CollectiveRecorder: unknown collective "
                             f"{func} (known: {sorted(COLLECTIVE_KINDS)})")
        schema = [a.name for a in func._schema.arguments]
        bound = dict(zip(schema, args))
        bound.update(kwargs)
        group = bound.get("group_name")
        res = out[0] if isinstance(out, (list, tuple)) else out
        nbytes = float(res.numel() * res.element_size())
        axis = "model" if group == self.model_group else "data"
        self.ops.append(CollectiveOp(kind, nbytes, len(self.ops), axis))

    def observe(self, func, args, kwargs, out) -> None:
        """Called with every local op the step runs (collectives too)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _is_fake(out) or any(_is_fake(a) for a in args):
            return out
        if func.namespace in _COLLECTIVE_NAMESPACES:
            self._record(func, args, kwargs, out)
        self.observe(func, args, kwargs, out)
        return out


@contextmanager
def record_collectives(mesh):
    """``with record_collectives(mesh) as ops:`` run a step on `mesh`; `ops`
    is then its collective program (a list of :class:`CollectiveOp`)."""
    rec = CollectiveRecorder(mesh)
    with rec:
        yield rec.ops


def synthetic_collective_ops(
    n_ops: int = 12,
    seed: int = 0,
    max_mb: int = 8,
    kinds: tuple[str, ...] = ("all-reduce", "all-gather", "reduce-scatter",
                              "all-to-all"),
) -> list[CollectiveOp]:
    """A seeded synthetic collective program: `n_ops` ops in program order
    with payloads in [1, max_mb] MiB and random mesh axes (kind, size and
    axis drawn per op, in that order).  The `dist_collectives` scenario in
    `repro_torch.scenarios` is built on this."""
    rng = np.random.default_rng(seed)
    ops: list[CollectiveOp] = []
    for i in range(max(1, n_ops)):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        mb = int(rng.integers(1, max(1, max_mb) + 1))
        axis = "model" if rng.random() < 0.5 else "data"
        ops.append(CollectiveOp(kind, mb * _BYTES_PER_UNIT, i, axis))
    return ops


def _op_demand(op: CollectiveOp, rows: int, cols: int) -> np.ndarray:
    """Traffic pattern of one collective on the rows x cols fabric.

    "model"-axis groups are the rows (consecutive device ids); "data"-axis
    groups are the columns.  Ring algorithms move ~bytes per hop, so each
    directed ring edge carries the op's unit count; all-to-all is dense
    within each group at units/(k-1) per pair."""
    m = rows * cols
    d = np.zeros((m, m), dtype=np.int64)
    units = max(1, int(round(op.bytes / _BYTES_PER_UNIT)))
    if op.axis == "model":
        groups = [np.arange(r * cols, (r + 1) * cols) for r in range(rows)]
    else:
        groups = [np.arange(c, m, cols) for c in range(cols)]
    for g in groups:
        k = g.size
        if k < 2:
            continue
        if op.kind == "all-to-all":
            per = max(1, units // (k - 1))
            for i in range(k):
                for j in range(k):
                    if i != j:
                        d[g[i], g[j]] = per
        else:  # ring: all-reduce / all-gather / reduce-scatter / permute
            for i in range(k):
                d[g[i], g[(i + 1) % k]] = units
    return d


def coflows_from_step(
    ops: list[CollectiveOp], rows: int, cols: int, n_buckets: int,
) -> Instance:
    """Bucket the step's collectives into `n_buckets` chained jobs (empty
    buckets dropped)."""
    m = rows * cols
    ordered = sorted(ops, key=lambda o: o.idx)
    chunks = [c for c in np.array_split(np.arange(len(ordered)), n_buckets)
              if c.size]
    jobs: list[Job] = []
    for jid, chunk in enumerate(chunks):
        coflows = [Coflow(jid, k, _op_demand(ordered[i], rows, cols))
                   for k, i in enumerate(chunk)]
        edges = [(k, k + 1) for k in range(len(coflows) - 1)]
        jobs.append(Job(jid, coflows, edges, weight=1.0, release=0))
    return Instance(m, jobs)


@dataclass
class PlanOutcome:
    """Planned collective phase: job order + makespans vs naive."""

    order: list[int]                  # planned job (bucket) permutation
    planner_makespan: float
    naive_makespan: float             # program-order one-at-a-time
    schedule: object = None           # the engine PlanResult
    session: object = None            # the SchedulerSession it was planned on

    @property
    def makespan_gain(self) -> float:
        if self.naive_makespan <= 0:
            return 0.0
        return 1.0 - self.planner_makespan / self.naive_makespan


def plan(instance: Instance, beta: float | None = None,
         seed: int | None = None, session=None, *,
         device=None, plan_backend: str | None = None) -> PlanOutcome:
    """Plan the collective phase with G-DM against a live scheduling session.

    The step's bucket jobs are submitted to a
    :class:`repro_torch.core.session.SchedulerSession` (a fresh one per
    call, on `device` (default ``"cuda"``) through `plan_backend`, unless
    an existing `session` is passed) and the session is drained; the
    planned permutation and makespan are read from the session's plan.  The
    returned outcome keeps the session, so callers can keep submitting
    follow-up phases against the same live fabric state: colliding jids
    (``coflows_from_step`` numbers every phase 0..n-1) are remapped to
    session-unique ids and the returned ``order`` is always in the
    CALLER's jid space, so ``bucket_order_from_plan`` keeps working across
    phases.  `beta`/`seed` configure the fresh session's scheduler
    (defaults 10.0 / 0); a shared session's scheduler options, device and
    plan backend are fixed at its creation, so passing any of them
    together with `session` raises."""
    from ..core.session import SchedulerSession

    if session is None:
        session = SchedulerSession(instance.m, "gdm",
                                   device="cuda" if device is None else device,
                                   plan_backend=plan_backend,
                                   beta=10.0 if beta is None else beta,
                                   seed=0 if seed is None else seed)
    elif beta is not None or seed is not None or device is not None \
            or plan_backend is not None:
        raise ValueError("beta/seed/device/plan_backend are fixed at session "
                         "creation; do not pass them together with an "
                         "existing session")
    elif session.m != instance.m:
        raise ValueError(f"session is on {session.m} ports, "
                         f"instance on {instance.m}")
    t0 = session.now
    existing = set(session.snapshot().submitted)
    next_jid = max(existing | {j.jid for j in instance.jobs}, default=-1) + 1
    to_caller: dict[int, int] = {}
    for j in instance.jobs:
        if j.jid in existing:
            to_caller[next_jid] = j.jid
            j = j.remap(next_jid)
            next_jid += 1
        else:
            to_caller[j.jid] = j.jid
        session.submit(j)
    session.advance()
    res = session.result()
    g = session.last_plan
    if g is None:
        raise ValueError("session has no engine plan to read the order from "
                         "(transcript-only scheduler, or nothing submitted); "
                         "build the session with a registered scheduler name")
    # the last replan's Algorithm 5 permutation covers the jobs still in
    # flight at that point; jobs that drained before an earlier reschedule
    # (staggered releases) are prepended in completion order so `order` is
    # always a total permutation of this call's jobs — downstream
    # bucket_order_from_plan indexes buckets by every position
    order = [to_caller[jid] for jid in g.schedule.meta["order"]
             if jid in to_caller]
    seen = set(order)
    done_first = sorted((jid for jid in to_caller
                         if to_caller[jid] not in seen),
                        key=lambda jid: (res.job_completions[jid], jid))
    order = [to_caller[jid] for jid in done_first] + order
    makespan = max(res.job_completions[jid] for jid in to_caller) - t0
    # naive: buckets one at a time in program order; each bucket is a chain
    # of coflows, each taking exactly its effective size (BNA, Lemma 1)
    naive = float(sum(c.D for j in instance.jobs for c in j.coflows))
    return PlanOutcome(order=order, planner_makespan=float(makespan),
                       naive_makespan=naive, schedule=g, session=session)


def bucket_order_from_plan(
    res: PlanOutcome, leaf_paths: list[str],
) -> list[list[str]]:
    """Planned job permutation -> gradient-bucket launch order.

    Splits `leaf_paths` into len(res.order) contiguous buckets (bucket j
    holds job j's gradients) and emits them in the planned order."""
    chunks = np.array_split(np.asarray(leaf_paths, dtype=object),
                            len(res.order))
    return [list(chunks[j]) for j in res.order]

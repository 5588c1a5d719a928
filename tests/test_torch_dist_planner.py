"""The port's collective planner (``repro_torch.dist.planner``) against
``repro.dist.planner``: the synthetic collective program, its translation to
a coflow instance on the pod fabric, ``plan`` on a fresh and on a shared
multi-phase ``SchedulerSession`` (the port's, on the CPU here), the
early-drain order, the three refusals, and ``bucket_order_from_plan``.
Orders and makespans must be equal, with no tolerance."""
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.dist import planner as ref_planner
from repro_torch.core import (Coflow, Instance, Job, SchedulerSession,
                              instance_to_arrays, om_alg)
from repro_torch.dist import planner

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def _ops_equal(got, want):
    assert [(o.kind, o.bytes, o.idx, o.axis) for o in got] == \
        [(o.kind, o.bytes, o.idx, o.axis) for o in want]


def _assert_instances_equal(got, want):
    a_m, a = instance_to_arrays(got)
    b_m, b = instance_to_arrays(want)
    assert a_m == b_m and len(a) == len(b)
    for x, y in zip(a, b):
        assert {k: x[k] for k in ("jid", "weight", "release", "edges")} == \
            {k: y[k] for k in ("jid", "weight", "release", "edges")}
        assert len(x["demands"]) == len(y["demands"])
        assert all(u.dtype == v.dtype and np.array_equal(u, v)
                   for u, v in zip(x["demands"], y["demands"]))


def _outcomes_equal(got, want):
    assert got.order == want.order
    assert got.planner_makespan == want.planner_makespan
    assert got.naive_makespan == want.naive_makespan
    assert got.makespan_gain == want.makespan_gain


@pytest.mark.parametrize("n_ops,seed,max_mb", [
    (12, 0, 8), (1, 3, 1), (0, 1, 4), (16, 7, 2), (128, 0, 8)])
def test_synthetic_ops_equal_reference(n_ops, seed, max_mb):
    got = planner.synthetic_collective_ops(n_ops=n_ops, seed=seed,
                                           max_mb=max_mb)
    want = ref_planner.synthetic_collective_ops(n_ops=n_ops, seed=seed,
                                                max_mb=max_mb)
    _ops_equal(got, want)
    assert len(got) == max(1, n_ops)


def test_synthetic_ops_kinds_equal_reference():
    kinds = ("all-to-all", "collective-permute")
    _ops_equal(planner.synthetic_collective_ops(20, seed=4, kinds=kinds),
               ref_planner.synthetic_collective_ops(20, seed=4, kinds=kinds))


@pytest.mark.parametrize("rows,cols", [(2, 2), (2, 4), (4, 3), (1, 5),
                                       (8, 8)])
@pytest.mark.parametrize("kind", KINDS)
def test_op_demand_equals_reference(kind, rows, cols):
    for axis in ("model", "data"):
        for nbytes in (1.0, 3.4 * 2 ** 20, 40 * 2 ** 20):
            op_p = planner.CollectiveOp(kind, nbytes, 0, axis)
            op_r = ref_planner.CollectiveOp(kind, nbytes, 0, axis)
            got = planner._op_demand(op_p, rows, cols)
            want = ref_planner._op_demand(op_r, rows, cols)
            assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("n_ops,rows,cols,n_buckets", [
    (16, 2, 4, 4), (5, 2, 2, 8), (12, 4, 4, 3), (128, 8, 8, 32),
    (7, 2, 6, 1)])
def test_coflows_from_step_equals_reference(n_ops, rows, cols, n_buckets):
    ops = planner.synthetic_collective_ops(n_ops=n_ops, seed=2)
    rops = ref_planner.synthetic_collective_ops(n_ops=n_ops, seed=2)
    # program order is read from idx, not from list order
    got = planner.coflows_from_step(ops[::-1], rows, cols, n_buckets)
    want = ref_planner.coflows_from_step(rops[::-1], rows, cols, n_buckets)
    _assert_instances_equal(got, want)
    assert got.n == min(n_ops, n_buckets)      # empty buckets dropped


@pytest.mark.parametrize("plan_backend", ["python", "pipeline"])
@pytest.mark.parametrize("n_ops,rows,cols,n_buckets,beta,seed", [
    (12, 2, 4, 4, None, None), (16, 4, 4, 6, 3.0, 2),
    (24, 2, 6, 8, None, 5)])
def test_plan_fresh_session_equals_reference(n_ops, rows, cols, n_buckets,
                                             beta, seed, plan_backend):
    rinst = ref_planner.coflows_from_step(
        ref_planner.synthetic_collective_ops(n_ops, seed=1), rows, cols,
        n_buckets)
    inst = planner.coflows_from_step(
        planner.synthetic_collective_ops(n_ops, seed=1), rows, cols,
        n_buckets)
    want = ref_planner.plan(rinst, beta=beta, seed=seed)
    got = planner.plan(inst, beta=beta, seed=seed, device="cpu",
                       plan_backend=plan_backend)
    _outcomes_equal(got, want)
    assert sorted(got.order) == list(range(inst.n))
    assert got.session.done and got.session.device == torch.device("cpu")
    assert got.session.plan_backend == plan_backend
    assert got.session.result().job_completions == \
        want.session.result().job_completions
    paths = [f"p{i}" for i in range(3 * inst.n + 1)]
    assert planner.bucket_order_from_plan(got, paths) == \
        ref_planner.bucket_order_from_plan(want, paths)


def test_plan_shared_session_multi_phase_equals_reference():
    """Three phases on one session, each numbered 0..n-1: jids remapped in
    the session, orders in the caller's space, equal to the reference's."""
    phases = [(4, 0, 2, 2, 2), (4, 1, 2, 2, 2), (9, 5, 2, 2, 3)]
    got_s = want_s = None
    for n_ops, seed, rows, cols, nb in phases:
        rinst = ref_planner.coflows_from_step(
            ref_planner.synthetic_collective_ops(n_ops=n_ops, seed=seed),
            rows, cols, nb)
        inst = planner.coflows_from_step(
            planner.synthetic_collective_ops(n_ops=n_ops, seed=seed),
            rows, cols, nb)
        want = ref_planner.plan(rinst, session=want_s)
        got = planner.plan(inst, session=got_s) if got_s else \
            planner.plan(inst, device="cpu")
        _outcomes_equal(got, want)
        assert sorted(got.order) == list(range(inst.n))
        got_s, want_s = got.session, want.session
        assert got_s.done
        paths = [f"p{i}" for i in range(6)]
        buckets = planner.bucket_order_from_plan(got, paths)
        assert buckets == ref_planner.bucket_order_from_plan(want, paths)
        assert sorted(x for b in buckets for x in b) == paths
    assert got_s.snapshot().submitted == want_s.snapshot().submitted
    assert got_s.result().job_completions == \
        want_s.result().job_completions


def test_plan_order_total_despite_early_drain():
    """tests/test_session.py::test_planner_order_total_despite_early_drain
    on the port, and equal to the reference's outcome."""
    m = 4
    d0 = np.zeros((m, m), np.int64)
    d0[0, 1] = 4
    d1 = np.zeros((m, m), np.int64)
    d1[2, 3] = 6
    inst = Instance(m, [Job(0, [Coflow(0, 0, d0)], [], weight=1.0, release=0),
                        Job(1, [Coflow(1, 0, d1)], [], weight=1.0,
                            release=100)])
    got = planner.plan(inst, device="cpu")
    assert sorted(got.order) == [0, 1]
    buckets = planner.bucket_order_from_plan(got, ["a", "b", "c", "d"])
    assert sorted(x for b in buckets for x in b) == ["a", "b", "c", "d"]
    rinst = ref_core.Instance(m, [
        ref_core.Job(0, [ref_core.Coflow(0, 0, d0)], [], weight=1.0),
        ref_core.Job(1, [ref_core.Coflow(1, 0, d1)], [], weight=1.0,
                     release=100)])
    _outcomes_equal(got, ref_planner.plan(rinst))


def _one_job(m=4):
    d = np.zeros((m, m), np.int64)
    d[0, 1] = 2
    return Instance(m, [Job(0, [Coflow(0, 0, d)], [], weight=1.0)])


def test_plan_refuses_options_with_a_shared_session():
    out = planner.plan(_one_job(), device="cpu")
    for kw in (dict(beta=5.0), dict(seed=1), dict(device="cpu"),
               dict(plan_backend="python")):
        with pytest.raises(ValueError, match="fixed at session creation"):
            planner.plan(_one_job(), session=out.session, **kw)


def test_plan_refuses_a_session_on_other_ports():
    out = planner.plan(_one_job(4), device="cpu")
    with pytest.raises(ValueError, match="session is on 4 ports"):
        planner.plan(_one_job(6), session=out.session)


def test_plan_refuses_plan_less_session():
    s = SchedulerSession(4, lambda sub: om_alg(sub, device="cpu").transcript(),
                         device="cpu")
    with pytest.raises(ValueError, match="no engine plan"):
        planner.plan(_one_job(), session=s)


def test_plan_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        planner.plan(_one_job())


def test_dist_package_names_only_the_planner():
    """The port's dist package names the planner, compression (since the
    training slice) and the partition rules (since the mesh slice); the
    planner has the reference's names, ``extract_collectives`` included,
    and the recorder that reads the same list from a DTensor step."""
    import repro_torch.dist as dist

    assert dist.__all__ == ["compression", "partition", "planner"]
    assert hasattr(planner, "extract_collectives")
    assert set(planner.__all__) == set(ref_planner.__all__) | \
        {"CollectiveRecorder", "record_collectives"}

"""The port's SchedulerSession: plan repair and the event API, mirroring
the reference's tests (tests/test_session.py) on the CPU.

The workloads are the reference test's own builders, converted through
``repro_torch.core.convert``; each repair test also runs the reference on
the same instance and requires equal completions and equal repair,
full-replan, reject and group counts — a repair that fires where the
reference's declines is a fault even when the plan comes out the same."""
import dataclasses
import math

import numpy as np
import pytest

import repro.core as ref
from repro_torch.core import (Coflow, Instance, Job, SchedulerSession,
                              instance_from_arrays, instance_to_arrays,
                              make_scheduler, om_alg, simulate_online)
from repro_torch.core.gdm import gdm

from test_session import (_append_workload, _geometric_append_workload,
                          _two_jobs)

COUNTS = ("reschedules", "repairs", "full_replans", "repair_rejects",
          "groups_reused", "groups_replanned")


def _port(inst):
    return instance_from_arrays(*instance_to_arrays(inst))


def _counts(res):
    return {k: res.stats["session"][k] for k in COUNTS}


def _run_both(inst, sched, **opts):
    """The port's session (python backend) and the reference's on one
    instance; completions and counters must be equal."""
    want = ref.simulate_online(inst, sched, driver="session", **opts)
    got = simulate_online(_port(inst), sched, driver="session",
                          device="cpu", **opts)
    assert got.job_completions == want.job_completions
    assert got.twct() == want.twct()
    assert _counts(got) == _counts(want)
    return got


def _port_two_jobs(m=4):
    j0, j1 = _two_jobs(m)
    return tuple(_port(ref.Instance(m, [j0, j1])).jobs)


# --- frontier-append plan repair -------------------------------------------

@pytest.mark.parametrize("plan_backend", ["python", "pipeline"])
def test_frontier_append_repair_fires_and_matches_full_replan(plan_backend):
    inst = _port(_append_workload())
    kw = dict(device="cpu", plan_backend=plan_backend)
    on = simulate_online(inst, "om_alg", driver="session", **kw)
    off = simulate_online(inst, "om_alg", driver="session", repair=False,
                          **kw)
    bat = simulate_online(inst, "om_alg", driver="batch", **kw)
    s_on, s_off = on.stats["session"], off.stats["session"]
    assert s_on["repairs"] == 3 and s_on["repair_rejects"] == 0
    assert s_on["full_replans"] == 1
    assert s_on["repair_hit_rate"] == pytest.approx(0.75)
    assert s_off["repairs"] == 0 and s_off["full_replans"] == 4
    assert on.job_completions == off.job_completions == bat.job_completions
    assert on.twct() == off.twct() == bat.twct()
    assert on.reschedules == off.reschedules == bat.reschedules == 4
    if plan_backend == "python":
        _run_both(_append_workload(), "om_alg")


def test_repaired_plan_keeps_its_device_and_plan_backend():
    """The spliced suffix and the concatenated parts carry the session's
    device and plan backend, so a lazy fix-up runs where the plan ran."""
    inst = _port(_append_workload())
    s = SchedulerSession(inst.m, "om_alg", device="cpu",
                         plan_backend="pipeline")
    for j in sorted(inst.jobs, key=lambda j: (j.release, j.jid)):
        s.submit(j)
    s.advance()
    assert s.stats.repairs == 3
    plan = s.last_plan
    assert plan.schedule.meta["repaired"]
    for part in plan.schedule.parts:
        assert str(part.device) == "cpu" and part.plan_backend == "pipeline"
    assert plan.schedule.parts[0].coflow_intervals().size > 0


def test_repair_rejects_mid_window_arrival():
    inst = _append_workload(appends=1)
    jobs = [dataclasses.replace(j, release=13) if j.jid == 2 else j
            for j in inst.jobs]
    inst = ref.Instance(inst.m, jobs)
    on = _run_both(inst, "om_alg")
    bat = simulate_online(_port(inst), "om_alg", driver="batch",
                          device="cpu")
    s = on.stats["session"]
    assert s["repairs"] == 0 and s["repair_rejects"] >= 1
    assert on.job_completions == bat.job_completions


def test_repair_never_fires_for_interleaving_schedulers():
    on = _run_both(_append_workload(), "gdm", seed=0)
    bat = simulate_online(_port(_append_workload()), "gdm", driver="batch",
                          seed=0, device="cpu")
    assert on.stats["session"]["repairs"] == 0
    assert on.job_completions == bat.job_completions


def test_repair_fires_for_spread_mode_gdm():
    inst = _geometric_append_workload()
    on = _run_both(inst, "gdm", delays="spread")
    pinst = _port(inst)
    off = simulate_online(pinst, "gdm", driver="session", repair=False,
                          delays="spread", device="cpu")
    bat = simulate_online(pinst, "gdm", driver="batch", delays="spread",
                          device="cpu")
    s_on = on.stats["session"]
    assert s_on["repairs"] == 3 and s_on["repair_rejects"] == 0
    assert s_on["full_replans"] == 1
    assert s_on["groups_reused"] >= 3
    assert on.job_completions == off.job_completions == bat.job_completions
    assert on.twct() == off.twct() == bat.twct()


@pytest.mark.parametrize("chain", [False, True])
def test_repair_fires_for_spread_mode_gdm_rt(chain):
    inst = _geometric_append_workload(scheduler="gdm_rt", chain=chain)
    on = _run_both(inst, "gdm_rt", delays="spread")
    pinst = _port(inst)
    off = simulate_online(pinst, "gdm_rt", driver="session", repair=False,
                          delays="spread", device="cpu")
    bat = simulate_online(pinst, "gdm_rt", driver="batch", delays="spread",
                          device="cpu")
    s_on = on.stats["session"]
    assert s_on["repairs"] >= 1 and s_on["groups_reused"] >= 1
    assert on.job_completions == off.job_completions == bat.job_completions
    assert on.twct() == off.twct() == bat.twct()


def _non_singleton_instance():
    """tests/test_session.py::test_spread_repair_reuses_non_singleton_group_
    block's workload, built with the port's own session as the probe."""
    m = 8
    sizes = {0: 16, 1: 60, 2: 64}   # jobs 1, 2 share a geometric group
    dems = {}
    for jid, size in sizes.items():
        d = np.zeros((m, m), np.int64)
        d[2 * jid, 2 * jid + 1] = size
        dems[jid] = d
    jobs = [Job(jid, [Coflow(jid, 0, dems[jid])], [],
                weight=1.0 - 0.1 * jid, release=0) for jid in sizes]
    plan0 = gdm(Instance(m, jobs), delays="spread", device="cpu")
    assert any(len(g) > 1 for g in plan0.meta["groups"])
    probe = SchedulerSession(m, "gdm", delays="spread", seed=0, device="cpu")
    for j in jobs:
        probe.submit(j)
    t = min(probe.frontier().completions.values())
    d_new = np.zeros((m, m), np.int64)
    d_new[6, 7] = 3000
    d_new[7, 6] = 16
    jobs.append(Job(3, [Coflow(3, 0, d_new)], [], weight=0.05,
                    release=int(t)))
    return Instance(m, jobs)


def test_spread_repair_reuses_non_singleton_group_block():
    pinst = _non_singleton_instance()
    rinst = ref.Instance(pinst.m, [
        ref.Job(j.jid, [ref.Coflow(c.jid, c.cid, c.demand)
                        for c in j.coflows], list(j.edges),
                weight=j.weight, release=j.release) for j in pinst.jobs])
    on = _run_both(rinst, "gdm", delays="spread")
    off = simulate_online(pinst, "gdm", driver="session", repair=False,
                          delays="spread", device="cpu")
    bat = simulate_online(pinst, "gdm", driver="batch", delays="spread",
                          device="cpu")
    s = on.stats["session"]
    assert s["repairs"] == 1 and s["groups_reused"] >= 1
    assert on.job_completions == off.job_completions == bat.job_completions
    assert on.twct() == off.twct() == bat.twct()


@pytest.mark.parametrize("plan_backend", ["python", "pipeline"])
def test_spread_repair_recomputes_inflight_group_and_reuses_rest(
        plan_backend):
    m = 8
    jobs = []
    for jid, size in enumerate([16, 48, 144]):
        d = np.zeros((m, m), np.int64)
        d[2 * jid, 2 * jid + 1] = size
        jobs.append(ref.Job(jid, [ref.Coflow(jid, 0, d)], [],
                            weight=2.0 ** -jid, release=0))
    d_new = np.zeros((m, m), np.int64)
    d_new[6, 7] = 500
    jobs.append(ref.Job(3, [ref.Coflow(3, 0, d_new)], [], weight=0.05,
                        release=8))
    inst = ref.Instance(m, jobs)
    if plan_backend == "python":
        _run_both(inst, "gdm", delays="spread")
    kw = dict(delays="spread", device="cpu", plan_backend=plan_backend)
    on = simulate_online(_port(inst), "gdm", driver="session", **kw)
    bat = simulate_online(_port(inst), "gdm", driver="batch", **kw)
    s = on.stats["session"]
    assert s["repairs"] == 1 and s["groups_reused"] >= 1
    assert s["groups_replanned"] >= 1
    assert on.job_completions == bat.job_completions
    assert on.twct() == bat.twct()


def test_legacy_repair_mode_keeps_old_gate():
    inst = _geometric_append_workload(scheduler="gdm_rt")
    new = _run_both(inst, "gdm_rt", delays="spread")
    old = _run_both(inst, "gdm_rt", repair="legacy", delays="spread")
    assert new.stats["session"]["repairs"] >= 1
    assert old.stats["session"]["repairs"] == 0
    assert new.job_completions == old.job_completions
    with pytest.raises(ValueError, match="repair"):
        SchedulerSession(8, "gdm", repair="sometimes", device="cpu")


# --- the event API -----------------------------------------------------------

def test_session_event_loop_submit_advance_result():
    j0, j1 = _port_two_jobs()
    s = SchedulerSession(4, "om_alg", device="cpu")
    s.submit(j0)
    s.submit(j1)
    assert not s.done
    with pytest.raises(RuntimeError):
        s.result()
    s.advance()
    assert s.done
    res = s.result()
    want = simulate_online(Instance(4, [j0, j1]), "om_alg", driver="batch",
                           device="cpu")
    assert res.job_completions == want.job_completions
    assert res.reschedules == want.reschedules
    assert s.now == pytest.approx(res.makespan)


def test_session_incremental_advance_matches_one_shot():
    j0, j1 = _port_two_jobs()
    a = SchedulerSession(4, "om_alg", device="cpu")
    for j in (j0, j1):
        a.submit(j)
    a.advance(until=5.0)
    assert a.now == 5.0
    snap = a.snapshot()
    assert snap.remaining_total() < 10
    a.advance()
    b = SchedulerSession(4, "om_alg", device="cpu")
    for j in (j0, j1):
        b.submit(j)
    b.advance()
    assert a.result().job_completions == b.result().job_completions


def test_session_prunes_drained_jobs_from_active_set():
    j0, j1 = _port_two_jobs()
    s = SchedulerSession(4, "om_alg", device="cpu")
    s.submit(j0)
    s.submit(j1)
    s.advance()
    assert s.snapshot().active == ()
    f = s.frontier()
    assert set(f.finished) == {0, 1} and f.completions == {}
    d = np.zeros((4, 4), np.int64)
    d[1, 2] = 3
    s.submit(Job(2, [Coflow(2, 0, d)], [], weight=1.0, release=0))
    s.advance()
    assert set(s.frontier().finished) == {0, 1, 2}
    assert len(s.result().job_completions) == 3


def test_session_retires_coflowless_jobs():
    s = SchedulerSession(4, "om_alg", device="cpu")
    s.submit(Job(0, [], [], weight=1.0, release=3))
    s.advance()
    assert s.snapshot().active == ()
    assert s.frontier().completion(0) == 3.0
    assert s.result().job_completions[0] == 3.0


def test_session_frontier_reports_planned_completions():
    j0, j1 = _port_two_jobs()
    s = SchedulerSession(4, "om_alg", device="cpu")
    s.submit(j0)
    f = s.frontier()
    assert f.now == 0.0
    assert f.completions[0] == pytest.approx(6.0)
    assert f.busy_until == pytest.approx(6.0)
    assert f.pending == ()
    s.submit(j1)
    assert s.frontier().pending == (1,)
    s.advance()
    f = s.frontier()
    assert f.completions == {}
    assert f.finished[0] == pytest.approx(6.0)
    assert f.order()[0] == 0
    assert f.completion(99) == math.inf


def test_frontier_equals_reference_frontier():
    """Mid-run frontiers and snapshots of the two sessions agree."""
    inst = _geometric_append_workload()
    pinst = _port(inst)
    a = ref.SchedulerSession(inst.m, "gdm", delays="spread", seed=0)
    b = SchedulerSession(inst.m, "gdm", delays="spread", seed=0,
                         device="cpu")
    for rj, pj in zip(inst.jobs, pinst.jobs):
        a.submit(rj)
        b.submit(pj)
    for t in (0.0, 3.0, 40.0, 400.0):
        a.advance(until=t)
        b.advance(until=t)
        fa, fb = a.frontier(), b.frontier()
        assert (fa.now, fa.busy_until, fa.completions, fa.finished,
                fa.pending) == (fb.now, fb.busy_until, fb.completions,
                                fb.finished, fb.pending)
        sa, sb = a.snapshot(), b.snapshot()
        assert sa.remaining.keys() == sb.remaining.keys()
        assert all(np.array_equal(sa.remaining[k], sb.remaining[k])
                   for k in sa.remaining)
        assert sa.done == sb.done and sa.active == sb.active


def test_session_rejects_duplicate_and_mismatched_jobs():
    j0, _ = _port_two_jobs()
    s = SchedulerSession(4, "om_alg", device="cpu")
    s.submit(j0)
    with pytest.raises(ValueError):
        s.submit(j0)
    with pytest.raises(ValueError):
        s.advance(until=-1.0)
    d = np.zeros((6, 6), np.int64)
    d[0, 1] = 1
    with pytest.raises(ValueError):
        s.submit(Job(7, [Coflow(7, 0, d)], []))


def test_session_backfilled_plan_entry():
    j0, j1 = _port_two_jobs()
    s = SchedulerSession(4, "om_alg", device="cpu")
    s.submit(j0)
    s.submit(j1)
    bf = s.backfilled_plan()
    assert bf.executor == "packet"
    assert bf.job_completions[0] == pytest.approx(6.0)
    assert s.backfilled_plan(exec="ledger").executor == "ledger"
    idle = SchedulerSession(4, "om_alg", device="cpu")
    with pytest.raises(ValueError):
        idle.backfilled_plan()


def test_session_accepts_plain_callables():
    j0, j1 = _port_two_jobs()
    inst = Instance(4, [j0, j1])

    def sched(sub):
        return om_alg(sub, device="cpu").transcript()

    res = simulate_online(inst, sched, driver="session", device="cpu")
    want = simulate_online(inst, sched, driver="batch", device="cpu")
    assert res.job_completions == want.job_completions
    s = SchedulerSession(4, sched, device="cpu")
    s.submit(j0)
    with pytest.raises(ValueError, match="no engine plan"):
        s.backfilled_plan()


def test_prebuilt_scheduler_must_agree_with_the_session():
    pre = make_scheduler("om_alg", device="cpu", plan_backend="pipeline")
    s = SchedulerSession(4, pre, device="cpu")        # adopts "pipeline"
    assert s.plan_backend == "pipeline"
    with pytest.raises(ValueError, match="prebuilt"):
        SchedulerSession(4, pre, device="cpu", plan_backend="python")
    with pytest.raises(TypeError):
        SchedulerSession(4, pre, device="cpu", seed=0)
    with pytest.raises(TypeError):
        SchedulerSession(4, "gdm", beta2=3.0, device="cpu")

"""The port's streaming harness (``repro_torch.core.stream``) on the CPU:
its generators draw the reference's numpy streams exactly; stream equals
batch inside the port on both plan backends; kill-and-resume is
bit-identical, also across plan backends; backpressure defers and rejects
under overload; and on BENCH_serve's generator (m = 8, mu = 2,
trace_seed = 7, load 0.9, overload 2.0 with ``AdmissionPolicy(16, 0.4,
16)``) a prefix of each cell gives the reference's twct and counts."""
import numpy as np
import pytest

import repro.core as ref
from repro.core.stream import StreamDriver as RefStreamDriver
from repro_torch.core import (AdmissionPolicy, Instance, SchedulerSession,
                              arrival_times, instance_from_arrays,
                              instance_to_arrays, run_stream,
                              simulate_online, stream_jobs)
from repro_torch.core.stream import StreamDriver

M = 8
MATRIX = [
    ("om_alg", {}),
    ("gdm", {"delays": "spread", "seed": 0}),
    ("gdm_rt", {"delays": "spread", "seed": 0}),
]
CPU = {"device": "cpu"}


def _trace(n=30, seed=3, process="poisson", load=0.9):
    return stream_jobs(M, n, seed, process=process, load=load, mu=2)


def _as_ref(jobs):
    """The port's jobs as the reference's (plain data in between)."""
    _, data = instance_to_arrays(Instance(M, list(jobs)))
    return [ref.Job(d["jid"], [ref.Coflow(d["jid"], k, x)
                               for k, x in enumerate(d["demands"])],
                    d["edges"], weight=d["weight"], release=d["release"])
            for d in data]


# --- the generators draw the reference's streams ----------------------------

@pytest.mark.parametrize("process", ["poisson", "mmpp"])
def test_arrival_times_equal_reference(process):
    for seed in (0, 9):
        got = arrival_times(300, 0.05, seed=seed, process=process)
        want = ref.arrival_times(300, 0.05, seed=seed, process=process)
        assert got.dtype == np.int64 and np.array_equal(got, want)
    got = arrival_times(500, 0.1, seed=1, process="mmpp", burst=16.0,
                        p_enter_burst=0.05, p_exit_burst=0.05)
    assert np.array_equal(got, ref.arrival_times(
        500, 0.1, seed=1, process="mmpp", burst=16.0, p_enter_burst=0.05,
        p_exit_burst=0.05))


def test_arrival_times_validation():
    with pytest.raises(ValueError, match="rate"):
        arrival_times(10, 0.0)
    with pytest.raises(ValueError, match="process"):
        arrival_times(10, 1.0, process="weibull")
    with pytest.raises(ValueError, match="burst"):
        arrival_times(10, 1.0, process="mmpp", burst=1.0)


@pytest.mark.parametrize("kw", [
    dict(n_jobs=20, seed=5, process="poisson", load=0.9, mu=2),
    dict(n_jobs=40, seed=7, process="mmpp", load=2.0, mu=2),
    dict(n_jobs=12, seed=1, process="poisson", load=0.7, mu=3, dag="chain",
         width_dist=("uniform", 2, 6), size_dist=("lognormal", 2.0, 1.0)),
])
def test_stream_jobs_equal_reference(kw):
    got = instance_to_arrays(Instance(M, stream_jobs(M, **kw)))[1]
    want = instance_to_arrays(ref.Instance(M, ref.stream_jobs(M, **kw)))[1]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("jid", "weight", "release", "edges")} == \
            {k: w[k] for k in ("jid", "weight", "release", "edges")}
        assert all(np.array_equal(a, b)
                   for a, b in zip(g["demands"], w["demands"]))


def test_sample_primitives_equal_reference():
    from repro.core import traces as ref_traces
    from repro_torch.core import traces

    for dist in (("loguniform", 2, 12), ("uniform", 3, 9), ("fixed", 4)):
        a, b = np.random.default_rng(4), np.random.default_rng(4)
        assert [traces.sample_width(a, dist, 50) for _ in range(20)] == \
            [ref_traces.sample_width(b, dist, 50) for _ in range(20)]
    for dist in (("lognormal", 3.0, 1.6), ("uniform", 1, 9),
                 ("pareto", 1.5, 8.0), ("fixed", 7)):
        a, b = np.random.default_rng(5), np.random.default_rng(5)
        assert np.array_equal(traces.sample_sizes(a, 40, dist, (1, 4096)),
                              ref_traces.sample_sizes(b, 40, dist,
                                                      (1, 4096)))
    for kind in ("uniform", "hotspot", "zipf"):
        a, b = traces.port_skew(M, kind), ref_traces.port_skew(M, kind)
        assert (a is None and b is None) or np.array_equal(a, b)
    skew = traces.port_skew(M, "hotspot", hot=2)
    got = traces.sample_coflows(M, 6, seed=2, src_skew=skew)
    want = ref_traces.sample_coflows(M, 6, seed=2, src_skew=skew)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        traces.sample_width(np.random.default_rng(0), ("beta", 1), 4)


# --- stream == batch inside the port, both plan backends --------------------

CELLS = [(s, o, "residual") for s, o in MATRIX] + \
    [(s, o, "pinned") for s, o in MATRIX[1:]]


@pytest.mark.parametrize("plan_backend", ["python", "pipeline"])
@pytest.mark.parametrize("sched,opts,gamma", CELLS)
@pytest.mark.parametrize("process", ["poisson", "mmpp"])
def test_stream_identical_to_batch_driver(sched, opts, gamma, process,
                                          plan_backend):
    jobs = _trace(process=process)
    kw = dict(gamma=gamma, device="cpu", plan_backend=plan_backend, **opts)
    res = run_stream(jobs, M, sched, **kw)
    batch = simulate_online(Instance(M, list(jobs)), sched, driver="batch",
                            **kw)
    assert res.online.job_completions == batch.job_completions
    assert res.online.twct() == batch.twct()
    assert res.offered == res.admitted == len(jobs)
    assert res.deferred == 0 and res.rejected == ()
    assert res.latencies_s.shape == (len(jobs),)
    assert res.p50_ms <= res.p95_ms <= res.p99_ms
    assert res.jobs_per_sec > 0
    if plan_backend == "python":   # and the reference's stream, counters too
        want = ref.run_stream(_as_ref(jobs), M, sched, gamma=gamma, **opts)
        assert res.online.job_completions == want.online.job_completions
        keys = ("repairs", "full_replans", "groups_reused", "gamma_rescales")
        assert {k: res.online.stats["session"][k] for k in keys} == \
            {k: want.online.stats["session"][k] for k in keys}


# --- kill-the-driver mid-stream ----------------------------------------------

@pytest.mark.parametrize("sched,opts", MATRIX)
@pytest.mark.parametrize("kill_at", [1, 7, 19])
def test_kill_and_resume_mid_stream_is_bit_identical(sched, opts, kill_at):
    jobs = _trace()
    want = run_stream(jobs, M, sched, **CPU, **opts)
    drv = StreamDriver(M, sched, **CPU, **opts)
    for j in jobs[:kill_at]:
        drv.feed(j)
    snap = drv.session.snapshot()
    resumed = SchedulerSession.restore(snap, jobs[:kill_at], sched, **CPU,
                                       **opts)
    for j in jobs[kill_at:]:
        resumed.submit(j)
    resumed.advance()
    out = resumed.result()
    assert out.job_completions == want.online.job_completions
    assert out.twct() == want.online.twct()


@pytest.mark.parametrize("first,then", [("python", "pipeline"),
                                        ("pipeline", "python")])
def test_snapshot_restores_on_the_other_plan_backend(first, then):
    """A snapshot is host data: taken on one plan backend, restored on the
    other, the run carries on bit-identically."""
    jobs = _trace()
    opts = {"delays": "spread", "seed": 0}
    want = run_stream(jobs, M, "gdm", **CPU, plan_backend=first, **opts)
    drv = StreamDriver(M, "gdm", **CPU, plan_backend=first, **opts)
    for j in jobs[:11]:
        drv.feed(j)
    resumed = SchedulerSession.restore(drv.session.snapshot(), jobs[:11],
                                       "gdm", **CPU, plan_backend=then,
                                       **opts)
    assert resumed.plan_backend == then
    for j in jobs[11:]:
        resumed.submit(j)
    resumed.advance()
    assert resumed.result().job_completions == want.online.job_completions


def test_restore_missing_job_raises():
    jobs = _trace(n=5)
    drv = StreamDriver(M, "om_alg", **CPU)
    for j in jobs:
        drv.feed(j)
    snap = drv.session.snapshot()
    with pytest.raises(ValueError, match="missing jids"):
        SchedulerSession.restore(snap, jobs[:-1], "om_alg", **CPU)


# --- backpressure --------------------------------------------------------------

def _overload_run(policy):
    jobs = stream_jobs(M, 60, 5, process="mmpp", load=2.5, mu=2)
    drv = StreamDriver(M, "gdm", admission=policy, delays="spread", seed=0,
                       **CPU)
    outcomes = [drv.feed(j) for j in jobs]
    return jobs, outcomes, drv.result()


def test_backpressure_defers_and_rejects_under_overload():
    policy = AdmissionPolicy(max_pending=4, replan_budget=0.3, window=8)
    jobs, outcomes, res = _overload_run(policy)
    assert "deferred" in outcomes and "rejected" in outcomes
    s = res.online.stats["session"]
    assert s["admission_deferred"] == res.deferred > 0
    assert s["admission_rejects"] == len(res.rejected) > 0
    assert res.admitted == res.offered - len(res.rejected)
    assert 0.0 <= s["replan_debt"] <= 1.0
    assert set(res.rejected).isdisjoint(res.online.job_completions)
    assert len(res.online.job_completions) == res.admitted
    # the reference's driver makes the same decisions on the same trace
    drv = RefStreamDriver(M, "gdm", admission=ref.AdmissionPolicy(
        max_pending=4, replan_budget=0.3, window=8), delays="spread", seed=0)
    assert [drv.feed(j) for j in _as_ref(jobs)] == outcomes
    want = drv.result()
    assert want.online.job_completions == res.online.job_completions
    assert want.rejected == res.rejected and want.deferred == res.deferred


def test_no_policy_means_no_backpressure():
    _, outcomes, res = _overload_run(None)
    assert set(outcomes) == {"submitted"}
    assert res.deferred == 0 and res.rejected == ()


def test_deferral_improves_repair_hit_rate_under_overload():
    policy = AdmissionPolicy(max_pending=32, replan_budget=0.3, window=8)
    _, _, pure = _overload_run(None)
    _, _, held = _overload_run(policy)
    assert held.online.stats["session"]["repair_hit_rate"] > \
        pure.online.stats["session"]["repair_hit_rate"]


def test_admission_policy_validation():
    for bad in (dict(max_pending=0), dict(replan_budget=1.5),
                dict(window=1), dict(max_pending=2.0)):
        with pytest.raises(ValueError):
            AdmissionPolicy(**bad)


# --- BENCH_serve's generator, a prefix of each cell ---------------------------

BENCH = dict(m=8, mu=2, trace_seed=7, load=0.9, overload=2.0)
PREFIX = 40
BENCH_CELLS = [(proc, sched, gamma) for proc in ("poisson", "mmpp")
               for sched in ("gdm", "gdm_rt")
               for gamma in ("residual", "pinned")]
BENCH_KEYS = ("twct", "session_full_replans", "session_repairs",
              "session_repair_hit_rate", "session_groups_reused",
              "session_gamma_rescales", "deferred", "rejected")


@pytest.mark.parametrize("proc,sched,gamma", BENCH_CELLS)
def test_bench_serve_prefix_equals_reference(proc, sched, gamma):
    jobs = stream_jobs(BENCH["m"], PREFIX, BENCH["trace_seed"], process=proc,
                       load=BENCH["load"], mu=BENCH["mu"])
    opts = {"delays": "spread", "seed": 0}
    got = run_stream(jobs, BENCH["m"], sched, gamma=gamma, **CPU, **opts)
    want = ref.run_stream(_as_ref(jobs), BENCH["m"], sched, gamma=gamma,
                          **opts)
    a, b = got.as_dict(), want.as_dict()
    assert {k: a[k] for k in BENCH_KEYS} == {k: b[k] for k in BENCH_KEYS}
    assert got.online.job_completions == want.online.job_completions
    if gamma == "pinned":
        assert a["session_repairs"] > 0


def test_bench_serve_overload_prefix_equals_reference():
    jobs = stream_jobs(BENCH["m"], 60, BENCH["trace_seed"], process="mmpp",
                       load=BENCH["overload"], mu=BENCH["mu"])
    opts = {"delays": "spread", "seed": 0}
    got = run_stream(jobs, BENCH["m"], "gdm", admission=AdmissionPolicy(
        16, 0.4, 16), **CPU, **opts).as_dict()
    want = ref.run_stream(_as_ref(jobs), BENCH["m"], "gdm",
                          admission=ref.AdmissionPolicy(16, 0.4, 16),
                          **opts).as_dict()
    assert {k: got[k] for k in BENCH_KEYS} == \
        {k: want[k] for k in BENCH_KEYS}
    assert got["deferred"] > 0


@pytest.mark.parametrize("sched", ["gdm", "gdm_rt"])
def test_spread_repair_hit_rate_floor_on_stream(sched):
    jobs = stream_jobs(M, 60, 7, process="poisson", load=1.1, mu=2)
    res = run_stream(jobs, M, sched, delays="spread", seed=0, **CPU)
    legacy = run_stream(jobs, M, sched, repair="legacy", delays="spread",
                        seed=0, **CPU)
    s, sl = res.online.stats["session"], legacy.online.stats["session"]
    assert s["repair_hit_rate"] > 0.02
    assert s["groups_reused"] > 0
    assert s["repair_hit_rate"] > sl["repair_hit_rate"]
    assert legacy.online.job_completions == res.online.job_completions

"""The port's pinned gamma (``repro_torch.core.gdm.GammaEpoch``) and the
session-side caches it feeds (``backend.group_block``,
``backend.grouping_prefix``), mirroring the reference's tests
(tests/test_gamma.py) on the CPU, with the port's epoch held to the
reference's on the same sequences of natural gammas."""
from fractions import Fraction

import numpy as np
import pytest

import repro.core as ref
from repro_torch.core import (GammaEpoch, Instance, SchedulerSession,
                              backend, cached_job_order, group_jobs,
                              instance_from_arrays, instance_to_arrays,
                              run_stream, simulate_online, stream_jobs)
from repro_torch.core.gdm import gdm
from repro_torch.core.ordering import job_load_vectors
from repro_torch.core.stream import StreamDriver

from test_algorithms import rand_instance

M = 8
CPU = {"device": "cpu"}


def _port(inst):
    return instance_from_arrays(*instance_to_arrays(inst))


def _trace(n=40, seed=7, process="poisson", load=1.1):
    return stream_jobs(M, n, seed, process=process, load=load, mu=2)


# --- the epoch ---------------------------------------------------------------

def test_gamma_epoch_monotone_downward_and_roundtrip():
    e = GammaEpoch()
    assert e.observe(5) == Fraction(5) and e.rescales == 0
    assert e.observe(7) == Fraction(5)
    assert e.observe(2) == Fraction(5, 4) and e.rescales == 2
    assert e.observe(1) == Fraction(5, 8) and e.rescales == 3
    assert e.observe(1) == Fraction(5, 8)
    e2 = GammaEpoch.from_state(e.state())
    assert e2.pinned == e.pinned and e2.rescales == e.rescales
    assert not e2.fixed
    assert GammaEpoch.from_state(GammaEpoch().state()).pinned is None

    fixed = GammaEpoch.from_policy(Fraction(3, 2))
    assert fixed.fixed and fixed.observe(1) == Fraction(3, 2)
    assert GammaEpoch.from_policy("residual") is None
    assert GammaEpoch.from_policy("pinned").pinned is None
    for bad in ("sticky", 0, -1, True, 1.5):
        with pytest.raises(ValueError, match="gamma"):
            GammaEpoch.from_policy(bad)
    with pytest.raises(ValueError, match="natural"):
        GammaEpoch().observe(0)
    with pytest.raises(ValueError, match="positive"):
        GammaEpoch(pinned=Fraction(-1))


def test_gamma_epoch_pin_is_path_independent():
    a = GammaEpoch()
    for nat in (12, 9, 9, 5, 5, 2):
        a.observe(nat)
    b = GammaEpoch()
    for nat in (12, 2):
        b.observe(nat)
    assert a.pinned == b.pinned
    assert a.rescales == b.rescales


@pytest.mark.parametrize("seed", range(4))
def test_gamma_epoch_equals_reference(seed):
    """Random sequences of natural gammas: the same pins, rescales and
    states as the reference's epoch, fixed pins included."""
    rng = np.random.default_rng(seed)
    naturals = [int(x) for x in rng.integers(1, 200, size=40)]
    for policy in ("pinned", 7, Fraction(5, 3)):
        a = GammaEpoch.from_policy(policy)
        b = ref.GammaEpoch.from_policy(policy)
        for nat in naturals:
            assert a.observe(nat) == b.observe(nat)
            assert a.state() == b.state()
        assert repr(a) == repr(b)


# --- grouping under a pinned gamma --------------------------------------------

def test_group_jobs_pinned_equals_residual_when_gamma_unchanged():
    for seed in range(3):
        inst = _port(rand_instance(seed + 9, n_jobs=6, releases=True))
        order = cached_job_order(inst, device="cpu").order
        residual = group_jobs(inst, order)
        pinned = group_jobs(inst, order, gamma=Fraction(inst.gamma()))
        assert residual == pinned
        finer = group_jobs(inst, order, gamma=Fraction(inst.gamma(), 2))
        assert sorted(j for g in finer for j in g) == \
            sorted(j for g in residual for j in g)
        rinst = rand_instance(seed + 9, n_jobs=6, releases=True)
        assert finer == ref.group_jobs(rinst, order,
                                       gamma=Fraction(inst.gamma(), 2))
    with pytest.raises(ValueError, match="gamma"):
        group_jobs(inst, order, gamma=0)


@pytest.mark.parametrize("plan_backend", ["python", "pipeline"])
def test_group_block_cache_identity(plan_backend):
    inst = _port(rand_instance(4, n_jobs=6, releases=True))
    kw = dict(delays="spread", device="cpu", plan_backend=plan_backend)
    backend.clear_caches()
    cached = gdm(inst, **kw)
    again = gdm(inst, **kw)
    with backend.no_caches():
        direct = gdm(inst, **kw)
    for other in (again, direct):
        assert cached.job_completions() == other.job_completions()
        assert [(e.t0, e.t1, e.jid, e.cid) for e in
                cached.transcript().entries] == \
            [(e.t0, e.t1, e.jid, e.cid) for e in
             other.transcript().entries]
    assert backend.cache_stats()["group"]["hits"] > 0


def test_group_block_rejects_randomized_modes():
    inst = _port(rand_instance(4, n_jobs=2))
    with pytest.raises(ValueError, match="spread"):
        backend.group_block("gdm", inst.jobs, inst.m, delays="random",
                            device="cpu")
    with pytest.raises(ValueError, match="kind"):
        backend.group_block("om_alg", inst.jobs, inst.m, delays="spread",
                            device="cpu")


def test_grouping_prefix_extends_cached_cumsum():
    inst = _port(rand_instance(11, n_jobs=5))
    order = cached_job_order(inst, device="cpu").order
    by_id = {j.jid: j for j in inst.jobs}
    sub = Instance(inst.m, [by_id[jid] for jid in order[:4]])
    backend.clear_caches()
    D4 = backend.grouping_prefix(sub, order[:4])
    assert dict(backend.cache_stats()["gkey"]["prefix"]) == \
        {"exact": 0, "extended": 0, "cold": 1}
    D5 = backend.grouping_prefix(inst, order)
    assert backend.cache_stats()["gkey"]["prefix"]["extended"] == 1
    assert np.array_equal(D5[:4], D4)
    rows = job_load_vectors([by_id[jid] for jid in order], inst.m)
    want = np.cumsum(rows, axis=0).max(axis=1).astype(np.int64)
    assert np.array_equal(D5, want)
    assert np.array_equal(backend.grouping_prefix(inst, order), D5)
    assert backend.cache_stats()["gkey"]["prefix"]["exact"] == 1


# --- the session under a pinned gamma -----------------------------------------

@pytest.mark.parametrize("sched", ["gdm", "gdm_rt"])
def test_pinned_stream_is_bit_identical_to_batch(sched):
    jobs = _trace()
    opts = {"delays": "spread", "seed": 0}
    res = run_stream(jobs, M, sched, gamma="pinned", **CPU, **opts)
    batch = simulate_online(Instance(M, list(jobs)), sched, driver="batch",
                            gamma="pinned", **CPU, **opts)
    assert res.online.job_completions == batch.job_completions
    assert res.online.twct() == batch.twct()


def test_gamma_needs_engine_gdm_scheduler():
    with pytest.raises(ValueError, match="gamma"):
        SchedulerSession(M, "om_alg", gamma="pinned", **CPU)
    with pytest.raises(ValueError, match="gamma"):
        simulate_online(Instance(M, _trace(n=3)), "om_alg", driver="batch",
                        gamma="pinned", **CPU)
    SchedulerSession(M, "gdm", gamma="pinned", delays="spread", **CPU)


@pytest.mark.parametrize("sched", ["gdm", "gdm_rt"])
def test_sustained_pinned_hit_rate_floor_and_rescale_accounting(sched):
    jobs = _trace(n=60)
    opts = {"delays": "spread", "seed": 0}
    pinned = run_stream(jobs, M, sched, gamma="pinned", **CPU, **opts)
    residual = run_stream(jobs, M, sched, **CPU, **opts)
    sp = pinned.online.stats["session"]
    sr = residual.online.stats["session"]
    assert sp["repair_hit_rate"] >= 0.4
    assert sp["repair_hit_rate"] > sr["repair_hit_rate"]
    assert sp["groups_reused"] > sr["groups_reused"]
    assert sp["gamma_rescales"] > 0
    assert sr["gamma_rescales"] == 0


@pytest.mark.parametrize("first,then", [("python", "python"),
                                        ("python", "pipeline"),
                                        ("pipeline", "python")])
def test_pinned_snapshot_restore_continues_bit_identically(first, then):
    jobs = _trace(n=30)
    opts = {"delays": "spread", "seed": 0}
    want = run_stream(jobs, M, "gdm", gamma="pinned", **CPU,
                      plan_backend=first, **opts)
    drv = StreamDriver(M, "gdm", gamma="pinned", **CPU, plan_backend=first,
                       **opts)
    for j in jobs[:11]:
        drv.feed(j)
    snap = drv.session.snapshot()
    assert snap.gamma_epoch is not None
    resumed = SchedulerSession.restore(snap, jobs[:11], "gdm",
                                       gamma="pinned", **CPU,
                                       plan_backend=then, **opts)
    assert resumed._gamma_epoch.state() == snap.gamma_epoch
    for j in jobs[11:]:
        resumed.submit(j)
    resumed.advance()
    out = resumed.result()
    assert out.job_completions == want.online.job_completions
    assert out.twct() == want.online.twct()

    drv2 = StreamDriver(M, "gdm", **CPU, **opts)
    for j in jobs[:5]:
        drv2.feed(j)
    assert drv2.session.snapshot().gamma_epoch is None

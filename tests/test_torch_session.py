"""The port's online protocol (``repro_torch.core.session`` /
``.online`` / ``engine.plan_online``) against the reference's
(``repro.core.session`` / ``.online``) on the CPU.

The same instances go through both packages (converted through
``repro_torch.core.convert``): job completions (floats, bit for bit),
twct, reschedule counts and the session's repair and full-replan counts
must be equal.  The port's python plan backend is held to the reference's
python backend (the CPU's default on both sides); the pipeline to the
reference's jit backend in ``tests/test_torch_online_pipeline.py``."""
import json
import math
from pathlib import Path

import pytest

import repro.core as ref
from repro import scenarios
from repro_torch.core import (OnlineResult, available_schedulers,
                              instance_from_arrays, instance_to_arrays,
                              make_scheduler, plan_online, poisson_releases,
                              simulate_online, theta0)

SCHEDULERS = sorted(available_schedulers())
GOLDEN_PATH = Path(__file__).parent / "goldens" / "session_equivalence.json"
# the reference's tiny per-scenario sizes (tests/test_session.py)
TINY = {
    "fb_like": dict(m=6, scale=0.03),
    "fb_like_rt": dict(m=6, scale=0.03),
    "alibaba_sparse": dict(m=6, scale=0.15),
    "incast": dict(m=6, scale=0.1),
    "shuffle_heavy": dict(m=6, scale=0.2),
    "wide_shallow": dict(m=6, scale=0.2),
    "deep_chain": dict(m=6, scale=0.25),
    "online_poisson": dict(m=6, scale=0.03),
    "dist_collectives": dict(m=8, scale=0.5),
}
COUNTS = ("reschedules", "repairs", "full_replans", "repair_rejects",
          "groups_reused", "groups_replanned", "gamma_rescales")


def _port(inst):
    return instance_from_arrays(*instance_to_arrays(inst))


def _online_instance(name: str):
    """As the reference's test builds it: native releases for poisson
    scenarios, Poisson-injected (by the reference) for offline ones."""
    built = scenarios.build(name, seed=0, **TINY[name])
    inst = built.instance
    if built.meta.arrival == "offline":
        inst = ref.poisson_releases(inst, theta=2 * ref.theta0(inst), seed=0)
    return inst, built.meta


def assert_online_equal(got, want, ctx, session=True):
    """Completions bit for bit, twct, reschedules, and (session driver) the
    session's counters."""
    assert got.job_completions == want.job_completions, \
        f"{ctx}: completions differ"
    assert got.twct() == want.twct(), f"{ctx}: twct differs"
    assert got.reschedules == want.reschedules, f"{ctx}: reschedules differ"
    if session:
        a, b = got.stats["session"], want.stats["session"]
        assert {k: a[k] for k in COUNTS} == {k: b[k] for k in COUNTS}, \
            f"{ctx}: session counters differ"


# --- the 9 x 6 scenario x scheduler matrix, both drivers ---------------------

@pytest.mark.parametrize("sched", SCHEDULERS)
@pytest.mark.parametrize("scen", sorted(TINY))
def test_matrix_equals_reference_both_drivers(scen, sched):
    inst, meta = _online_instance(scen)
    opts = scenarios.scheduler_opts(sched, meta)
    pinst = _port(inst)
    for driver in ("batch", "session"):
        want = ref.simulate_online(inst, sched, driver=driver, seed=0, **opts)
        got = simulate_online(pinst, sched, driver=driver, seed=0,
                              device="cpu", **opts)
        assert_online_equal(got, want, f"{scen}/{sched}/{driver}",
                            session=driver == "session")
        if driver == "session":
            s = got.stats["session"]
            assert s["repairs"] + s["full_replans"] == s["reschedules"]
            batch = simulate_online(pinst, sched, driver="batch", seed=0,
                                    device="cpu", **opts)
            assert got.job_completions == batch.job_completions


def test_session_equivalence_golden():
    """tests/goldens/session_equivalence.json, the reference's pinned
    online_poisson shape, under both of the port's drivers."""
    built = scenarios.build("online_poisson", m=6, seed=0, scale=0.03)
    inst = _port(built.instance)
    want = json.loads(GOLDEN_PATH.read_text())
    for driver in ("batch", "session"):
        r = simulate_online(inst, "gdm", driver=driver, seed=0, device="cpu")
        row = {"twct": r.twct(), "reschedules": r.reschedules,
               "job_completions": {str(k): v for k, v in
                                   sorted(r.job_completions.items())}}
        assert row == want, driver


def test_poisson_releases_and_theta0_equal_reference():
    built = scenarios.build("fb_like", seed=0, **TINY["fb_like"])
    inst = built.instance
    assert theta0(_port(inst)) == ref.theta0(inst)
    for seed in range(3):
        want = ref.poisson_releases(inst, theta=3 * ref.theta0(inst),
                                    seed=seed)
        got = poisson_releases(_port(inst), theta=3 * ref.theta0(inst),
                               seed=seed)
        assert [j.release for j in got.jobs] == [j.release for j in want.jobs]


# --- plan_online ---------------------------------------------------------------

@pytest.mark.parametrize("driver", ["session", "batch"])
def test_plan_online_equals_reference(driver):
    inst, _ = _online_instance("online_poisson")
    want = ref.plan_online(inst, "gdm", seed=0, driver=driver)
    got = plan_online(_port(inst), "gdm", seed=0, driver=driver,
                      device="cpu")
    assert_online_equal(got, want, driver, session=driver == "session")
    assert set(got.stats) == set(want.stats)
    assert got.stats["driver"] == driver
    for cache in ("bna", "order", "group"):
        assert set(got.stats[cache]) == {"hits", "misses", "hit_rate"}
    assert ("session" in got.stats) == (driver == "session")


def test_plan_online_from_scratch_and_prebuilt_scheduler():
    """incremental=False (caches off) and a prebuilt scheduler, which
    brings its own device and plan backend, plan the same."""
    inst, _ = _online_instance("online_poisson")
    pinst = _port(inst)
    warm = plan_online(pinst, "om_alg", device="cpu")
    cold = plan_online(pinst, "om_alg", device="cpu", incremental=False)
    assert cold.stats["bna"]["hits"] == 0 and not cold.stats["incremental"]
    for pb in ("python", "pipeline"):
        pre = plan_online(pinst, make_scheduler("om_alg", device="cpu",
                                                plan_backend=pb))
        assert pre.job_completions == warm.job_completions
    assert warm.job_completions == cold.job_completions
    with pytest.raises(TypeError):
        plan_online(pinst, make_scheduler("om_alg", device="cpu"), seed=1)


def test_unknown_driver_and_options_rejected():
    inst, _ = _online_instance("fb_like")
    pinst = _port(inst)
    with pytest.raises(ValueError):
        simulate_online(pinst, "gdm", driver="batch_v2", device="cpu")
    with pytest.raises(TypeError):
        simulate_online(pinst, "gdm_bf", excc="ledger", device="cpu")
    with pytest.raises(TypeError):
        plan_online(pinst, "gdm", sseed=1, device="cpu")
    with pytest.raises(TypeError, match="override"):
        make_scheduler("om_alg", device="cpu").plan_full(pinst, gamma=2)


def test_plan_full_override_equals_bound_option():
    """plan_full(**overrides) plans as make_scheduler with the option
    bound, and leaves the bound options as they were."""
    inst, _ = _online_instance("online_poisson")
    pinst = _port(inst)
    s = make_scheduler("gdm", device="cpu", delays="spread")
    a = s.plan_full(pinst, gamma=1)
    b = make_scheduler("gdm", device="cpu", delays="spread",
                       gamma=1).plan_full(pinst)
    assert a.job_completions() == b.job_completions()
    assert a.schedule.meta["gamma"] == 1 and s.opts == {"delays": "spread"}


def test_online_result_twct_and_makespan():
    inst, _ = _online_instance("incast")
    res = simulate_online(_port(inst), "om_alg", device="cpu")
    assert isinstance(res, OnlineResult)
    assert res.makespan == max(res.job_completions.values())
    assert math.isclose(res.twct(), sum(
        j.weight * (res.job_completions[j.jid] - j.release)
        for j in res.instance.jobs))


def test_cuda_without_a_card_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    inst, _ = _online_instance("incast")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        simulate_online(_port(inst), "om_alg")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        plan_online(_port(inst), "om_alg", driver="batch")

"""The port's online drivers on the pipeline plan backend against the
reference's jit backend (``use_plan_backend("jit")``), on the CPU: the
session golden's online_poisson shape and one offline scenario with
Poisson releases, both drivers.  The reference's jit compiles per bucket
shape on XLA-CPU (seconds each), so this stays at these two instances."""
import pytest

import repro.core as ref
from repro import scenarios
from repro.core import backend as ref_backend
from repro_torch.core import (clear_caches, instance_from_arrays,
                              instance_to_arrays, simulate_online)
from test_torch_session_counters import assert_counters_equal

COUNTS = ("reschedules", "repairs", "full_replans", "repair_rejects",
          "groups_reused", "groups_replanned")


def _instances():
    golden = scenarios.build("online_poisson", m=6, seed=0, scale=0.03)
    built = scenarios.build("incast", m=6, seed=0, scale=0.1)
    inc = ref.poisson_releases(built.instance,
                               theta=2 * ref.theta0(built.instance), seed=0)
    return {"online_poisson": golden.instance, "incast": inc}


@pytest.mark.parametrize("name", ["online_poisson", "incast"])
def test_pipeline_online_equals_reference_jit(name):
    inst = _instances()[name]
    pinst = instance_from_arrays(*instance_to_arrays(inst))
    cells = [("gdm", {"seed": 0}),
             ("gdm", {"seed": 0, "delays": "spread", "gamma": "pinned"}),
             ("om_alg", {})]
    with ref_backend.use_plan_backend("jit"):
        for sched, opts in cells:
            for driver in ("batch", "session"):
                ref_backend.clear_caches()
                clear_caches()
                want = ref.simulate_online(inst, sched, driver=driver, **opts)
                got = simulate_online(pinst, sched, driver=driver,
                                      device="cpu", plan_backend="pipeline",
                                      **opts)
                ctx = f"{name}/{sched}/{opts}/{driver}"
                assert got.job_completions == want.job_completions, ctx
                assert got.twct() == want.twct(), ctx
                assert got.reschedules == want.reschedules, ctx
                if driver == "session":
                    a, b = got.stats["session"], want.stats["session"]
                    assert {k: a[k] for k in COUNTS} == \
                        {k: b[k] for k in COUNTS}, ctx


@pytest.mark.parametrize("sched", ["gdm", "om_alg", "gdm_rt"])
def test_pipeline_session_counters_equal_reference_jit(sched):
    """The session's counters and the bna, order and group hit counts of
    ``plan_online`` on the paper workload (m = 150, scale 0.1, releases at
    theta0), the port's pipeline against the reference's jit backend
    (tests/test_torch_session_counters.py holds the python pair)."""
    with ref_backend.use_plan_backend("jit"):
        assert_counters_equal(sched, "pipeline")

"""The online session's cache counters against the reference's, python
plan backend (the reference's default on the CPU): ``plan_online`` of
``paper_workload(m=150, mu_bar=5, seed=0, scale=0.1)`` with
``poisson_releases(theta0)`` for gdm, om_alg and gdm_rt (``rooted=True``).
Twct, completions, every counter of the session (all but its wall clocks)
and the bna, order and group hit and miss counts must be equal.  The
pipeline's pair (the reference's jit backend) is in
tests/test_torch_online_pipeline.py: the two backends count differently
(gdm's bna cache hits 149 times here and 58 times there, with 33 misses
on each), so each is held to its own counterpart."""
import pytest

import repro.core as ref
from repro.core import backend as ref_backend
from repro_torch.core import (clear_caches, instance_from_arrays,
                              instance_to_arrays, plan_online)

CACHES = ("bna", "order", "group")
# gdm's bna counts through each pair of backends, (hits, misses)
GDM_BNA = {"python": (149, 33), "pipeline": (58, 33)}


def online_paper_workload(sched: str):
    inst = ref.paper_workload(m=150, mu_bar=5, seed=0, scale=0.1,
                              rooted=sched == "gdm_rt")
    return ref.poisson_releases(inst, theta=ref.theta0(inst), seed=0)


def assert_counters_equal(sched: str, plan_backend: str) -> None:
    """One plan_online through the port (on `plan_backend`) against the
    reference's run on the current reference backend, caches cleared
    before each."""
    inst = online_paper_workload(sched)
    ref_backend.clear_caches()
    want = ref.plan_online(inst, sched, seed=0)
    clear_caches()
    got = plan_online(instance_from_arrays(*instance_to_arrays(inst)),
                      sched, seed=0, device="cpu", plan_backend=plan_backend)
    assert got.job_completions == want.job_completions
    assert got.twct() == want.twct()
    assert got.stats["reschedules"] == want.stats["reschedules"]
    counters = [k for k in want.stats["session"] if not k.endswith("wall_s")]
    assert {k: got.stats["session"][k] for k in counters} == \
        {k: want.stats["session"][k] for k in counters}
    for cache in CACHES:
        assert got.stats[cache] == want.stats[cache], cache
    if sched == "gdm":
        assert (got.stats["bna"]["hits"], got.stats["bna"]["misses"]) == \
            GDM_BNA[plan_backend]


@pytest.mark.parametrize("sched", ["gdm", "om_alg", "gdm_rt"])
def test_python_backend_counters_equal_reference(sched):
    assert_counters_equal(sched, "python")

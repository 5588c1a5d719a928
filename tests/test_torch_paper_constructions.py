"""The paper's analytical constructions on the port against the reference's:
Lemma 2's sqrt(mu) optimality-gap instance (``gap_instance``,
``gap_bounds``, ``gap_optimal_schedule_length``, ``gap_hand_schedule``)
and Theorem 1's flow-shop reduction (``fsp_to_coflow_job``).  Instances
are compared as plain data through ``instance_to_arrays``; plans by gdm,
gdm_rt, om_alg and ``dma_srt`` on them must equal the reference's plans
(transcripts, completions, twct, makespan), with no tolerance."""
import numpy as np
import pytest

import repro.core as ref
from repro_torch.core import (clear_caches, dma_srt, fsp_to_coflow_job,
                              gap_bounds, gap_hand_schedule, gap_instance,
                              gap_optimal_schedule_length, instance_to_arrays,
                              is_rooted_tree, plan, transcript_to_arrays,
                              verify_schedule, verify_transcript)


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


def _assert_plans_equal(got, want, ctx):
    a = transcript_to_arrays(got.transcript())
    b = transcript_to_arrays(want.transcript())
    assert len(a) == len(b), f"{ctx}: {len(a)} entries != {len(b)}"
    for i, (x, y) in enumerate(zip(a, b)):
        assert x[:4] == y[:4], f"{ctx}: entry {i} {x[:4]} != {y[:4]}"
        assert all(u.dtype == v.dtype and np.array_equal(u, v)
                   for u, v in zip(x[4:], y[4:])), f"{ctx}: entry {i}"
    assert got.job_completions() == want.job_completions(), ctx
    assert got.twct() == want.twct(), ctx
    assert got.makespan == want.makespan, ctx


def fsp_times(machines: int, jobs: int, seed: int) -> np.ndarray:
    """Flow-shop processing times: integers 1-100 from ``default_rng(seed)``."""
    return np.random.default_rng(seed).integers(1, 101, size=(machines, jobs))


# --- Lemma 2 ---------------------------------------------------------------

@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
def test_gap_instance_equals_reference(K, d):
    got, want = gap_instance(K, d=d), ref.gap_instance(K, d=d)
    _assert_instances_equal(got, want)
    assert got.m == 2 * K + 2 and got.jobs[0].mu == (2 * K) ** 2
    assert gap_bounds(got) == ref.gap_bounds(want) == (2 * K * d, 2 * K * d)
    assert gap_optimal_schedule_length(K, d) == \
        ref.gap_optimal_schedule_length(K, d) == (2 * K + 1) * K * d
    assert gap_hand_schedule(K, d) == ref.gap_hand_schedule(K, d)


def test_gap_instance_explicit_m_and_refusal():
    _assert_instances_equal(gap_instance(3, d=2, m=11),
                            ref.gap_instance(3, d=2, m=11))
    for mod in (ref, None):
        with pytest.raises(AssertionError):
            (mod.gap_instance if mod else gap_instance)(3, m=6)


@pytest.mark.parametrize("K", [2, 3])
def test_gap_hand_schedule_lemma2(K):
    """tests/test_algorithms.py::test_gap_instance_lemma2 on the port."""
    inst = gap_instance(K, d=2)
    delta, T = gap_bounds(inst)
    assert delta == T == 2 * K * 2
    assert gap_optimal_schedule_length(K, 2) == (2 * K + 1) * K * 2
    rounds = gap_hand_schedule(K, d=2)
    job = inst.jobs[0]
    parents = {c: set() for c in range(job.mu)}
    for a, b in job.edges:
        parents[b].add(a)
    done = set()
    for t, ids in rounds:
        for c in ids:
            assert parents[c] <= done, f"round at {t} violates precedence"
        senders = [np.nonzero(job.coflows[c].demand)[0][0] for c in ids]
        receivers = [np.nonzero(job.coflows[c].demand)[1][0] for c in ids]
        assert len(set(senders)) == len(senders)
        assert len(set(receivers)) == len(receivers)
        done |= set(ids)
    assert done == set(range(job.mu))
    assert rounds[-1][0] + 2 == gap_optimal_schedule_length(K, 2)


# --- Theorem 1 -------------------------------------------------------------

FSP = {
    "test_algorithms_3x2": np.array([[3, 1], [2, 4], [5, 2]]),
    "one_machine": np.array([[4, 1, 7]]),
    "random_4x5": fsp_times(4, 5, seed=3),
    "random_8x32": fsp_times(8, 32, seed=0),
}


@pytest.mark.parametrize("name", sorted(FSP))
def test_fsp_reduction_equals_reference(name):
    p = FSP[name]
    got, want = fsp_to_coflow_job(p), ref.fsp_to_coflow_job(p)
    _assert_instances_equal(got, want)
    job = got.jobs[0]
    assert job.mu == p.size + 1 and got.m == max(p.shape[0], 2)
    assert is_rooted_tree(job) and ref.is_rooted_tree(want.jobs[0])


def test_fsp_reduction_refuses_nonpositive_times():
    p = np.array([[3, 0], [2, 4]])
    for fn in (fsp_to_coflow_job, ref.fsp_to_coflow_job):
        with pytest.raises(AssertionError):
            fn(p)


def test_fsp_reduction_structure():
    """tests/test_algorithms.py::test_fsp_reduction_structure on the port."""
    inst = fsp_to_coflow_job(FSP["test_algorithms_3x2"])
    job = inst.jobs[0]
    assert job.mu == 3 * 2 + 1
    assert is_rooted_tree(job)
    sched = dma_srt(job, inst.m, rng=np.random.default_rng(0), device="cpu")
    verify_schedule(inst, sched)


# --- plans on the constructions equal the reference's ----------------------

INSTANCES = {
    "gap_K2_d1": lambda mod: mod.gap_instance(2, d=1),
    "gap_K3_d2": lambda mod: mod.gap_instance(3, d=2),
    "gap_K4_d1": lambda mod: mod.gap_instance(4, d=1),
    "fsp_3x2": lambda mod: mod.fsp_to_coflow_job(FSP["test_algorithms_3x2"]),
    "fsp_4x5": lambda mod: mod.fsp_to_coflow_job(FSP["random_4x5"]),
}


def _opts(name, sched):
    # the gap job is a general DAG: G-DM-RT's tree machinery needs
    # require_tree=False there (scenarios.scheduler_opts' rule)
    return {"require_tree": False} if sched == "gdm_rt" and \
        name.startswith("gap") else {}


@pytest.mark.parametrize("sched", ["gdm", "gdm_rt", "om_alg"])
@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_plan_on_constructions_equals_reference(name, sched):
    import repro_torch.core as port

    inst = INSTANCES[name](port)
    want = ref.plan(INSTANCES[name](ref), sched, seed=0, **_opts(name, sched))
    clear_caches()
    got = plan(inst, sched, device="cpu", seed=0, **_opts(name, sched))
    _assert_plans_equal(got, want, f"{name}/{sched}")
    verify_transcript(inst, got.transcript())
    # the pipeline's plain versions give the python path's plan
    clear_caches()
    pipe = plan(inst, sched, device="cpu", plan_backend="pipeline", seed=0,
                **_opts(name, sched))
    _assert_plans_equal(pipe, got, f"{name}/{sched} pipeline")
    if name.startswith("gap"):
        K = {"gap_K2_d1": 2, "gap_K3_d2": 3, "gap_K4_d1": 4}[name]
        d = 2 if name == "gap_K3_d2" else 1
        # no schedule beats the simple bounds; the optimum is (2K+1)Kd
        assert got.makespan >= max(gap_bounds(inst))
        assert got.makespan >= gap_optimal_schedule_length(K, d)


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_dma_srt_on_constructions_equals_reference(name):
    import repro_torch.core as port

    inst, rinst = INSTANCES[name](port), INSTANCES[name](ref)
    tree = not name.startswith("gap")
    got = dma_srt(inst.jobs[0], inst.m, rng=np.random.default_rng(0),
                  require_tree=tree, device="cpu")
    want = ref.dma_srt(rinst.jobs[0], rinst.m, rng=np.random.default_rng(0),
                       require_tree=tree)
    for field in ("events", "alphas", "exp"):
        assert np.array_equal(getattr(got, field), getattr(want, field)), \
            f"{name}: {field} differs"
    assert got.coflow_completions() == want.coflow_completions()
    assert got.job_completions() == want.job_completions()
    assert got.makespan == want.makespan
    verify_schedule(inst, got)

"""The port's scenario registry and workload zoo (``repro_torch.scenarios``)
and ``workload_stats`` / ``PAPER_STATS`` against the reference's.

Every scenario at tests/test_scenarios.py's TINY and MID sizes and at its
builder's defaults, for seeds 0-3, must build an instance equal to the
reference's (compared as plain data through ``instance_to_arrays``: jids,
weights, releases, edges and every demand's dtype and values) with equal
metadata.  The reference's per-pair invariant bundle
(tests/test_scenarios.py::_assert_invariants) runs on the port at TINY for
all six schedulers, each plan's twct equal to the reference's plan of the
same instance and, on fb_like, to tests/goldens/scenario_goldens.json."""
import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import pytest

import repro.core as ref
from repro import scenarios as ref_scenarios
from repro_torch import scenarios
from repro_torch.core import (PAPER_STATS, Coflow, Instance, Job,
                              available_schedulers, backfill, clear_caches,
                              instance_to_arrays, make_scheduler, plan,
                              simulate_online, twct, verify_schedule,
                              verify_transcript, workload_stats)

GOLDEN_PATH = Path(__file__).parent / "goldens" / "scenario_goldens.json"
SCHEDULERS = sorted(available_schedulers())
SEEDS = (0, 1, 2, 3)
# tests/test_scenarios.py's sizes
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
MID = {
    "fb_like": dict(m=14, scale=0.06),
    "fb_like_rt": dict(m=14, scale=0.06),
    "alibaba_sparse": dict(m=14, scale=0.3),
    "incast": dict(m=14, scale=0.25),
    "shuffle_heavy": dict(m=12, scale=0.35),
    "wide_shallow": dict(m=14, scale=0.3),
    "deep_chain": dict(m=12, scale=0.4),
    "online_poisson": dict(m=14, scale=0.06),
    "dist_collectives": dict(m=12, scale=1.0),
}
SIZES = {"tiny": TINY, "mid": MID, "defaults": {n: {} for n in TINY}}


def assert_instances_equal(got, want, ctx=""):
    """Port and reference instances equal as plain data, bit for bit."""
    a_m, a = instance_to_arrays(got)
    b_m, b = instance_to_arrays(want)
    assert a_m == b_m and len(a) == len(b), f"{ctx}: m or job count differs"
    for x, y in zip(a, b):
        assert {k: x[k] for k in ("jid", "weight", "release", "edges")} == \
            {k: y[k] for k in ("jid", "weight", "release", "edges")}, \
            f"{ctx}: job {x['jid']} differs"
        assert len(x["demands"]) == len(y["demands"]), ctx
        for u, v in zip(x["demands"], y["demands"]):
            assert u.dtype == v.dtype and np.array_equal(u, v), \
                f"{ctx}: job {x['jid']}: a demand differs"
    # the port's own objects carry the int64 demands the schedulers read
    for j in got.jobs:
        for c in j.coflows:
            assert c.demand.dtype == np.int64 and c.jid == j.jid


def _meta_dict(meta) -> dict:
    return dataclasses.asdict(meta)


@functools.lru_cache(maxsize=None)
def tiny(name):
    return scenarios.build(name, seed=0, **TINY[name])


@functools.lru_cache(maxsize=None)
def ref_tiny(name):
    return ref_scenarios.build(name, seed=0, **TINY[name])


# --- the registry API ------------------------------------------------------

def test_registry_names_and_docs_equal_reference():
    assert scenarios.names() == ref_scenarios.names()
    assert len(scenarios.names()) == 9
    assert scenarios.available() == ref_scenarios.available()
    assert all(scenarios.available().values())


def test_registry_get_unknown_and_duplicate():
    s = scenarios.get("incast")
    assert s.name == "incast" and callable(s.builder)
    assert s.doc == ref_scenarios.get("incast").doc
    with pytest.raises(KeyError):
        scenarios.get("nope")
    with pytest.raises(ValueError):
        scenarios.register("fb_like")(lambda **kw: None)
    assert scenarios.names() == ref_scenarios.names()


@pytest.mark.parametrize("m", [9, 2, 3])
def test_dist_collectives_refuses_odd_or_small_m(m):
    with pytest.raises(ValueError) as want:
        ref_scenarios.build("dist_collectives", m=m)
    with pytest.raises(ValueError) as got:
        scenarios.build("dist_collectives", m=m)
    assert str(got.value) == str(want.value)
    assert scenarios.build("dist_collectives", m=8).instance.m == 8


# --- the generators, bit for bit -----------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("scen", sorted(TINY))
def test_build_equals_reference(scen, size, seed):
    kw = SIZES[size][scen]
    got = scenarios.build(scen, seed=seed, **kw)
    want = ref_scenarios.build(scen, seed=seed, **kw)
    assert isinstance(got, scenarios.BuiltScenario)
    assert isinstance(got.meta, scenarios.ScenarioMeta)
    assert_instances_equal(got.instance, want.instance,
                           f"{scen}/{size}/seed {seed}")
    assert _meta_dict(got.meta) == _meta_dict(want.meta)
    scenarios.check_bounds(got)


@pytest.mark.parametrize("scen,kw", [
    ("fb_like", dict(m=10, mu_bar=3, weights="random")),
    ("fb_like_rt", dict(m=10, mu_bar=2, scale=0.05)),
    ("wide_shallow", dict(m=9, mu=3, scale=0.4)),
    ("deep_chain", dict(m=7, depth=4, scale=0.5)),
    ("online_poisson", dict(m=8, mu_bar=3, load=1.5, scale=0.05)),
    ("dist_collectives", dict(m=10, max_mb=3, scale=2.0)),
])
def test_builder_keywords_equal_reference(scen, kw):
    got = scenarios.build(scen, seed=5, **kw)
    want = ref_scenarios.build(scen, seed=5, **kw)
    assert_instances_equal(got.instance, want.instance, f"{scen}/{kw}")
    assert _meta_dict(got.meta) == _meta_dict(want.meta)
    scenarios.check_bounds(got)


def test_check_bounds_catches_a_broken_contract():
    built = tiny("deep_chain")
    bad = scenarios.BuiltScenario(built.instance, dataclasses.replace(
        built.meta, bounds={**built.meta.bounds, "n_jobs_max": 0}))
    with pytest.raises(AssertionError):
        scenarios.check_bounds(bad)
    with pytest.raises(AssertionError):
        ref_scenarios.check_bounds(ref_scenarios.BuiltScenario(
            ref_tiny("deep_chain").instance, dataclasses.replace(
                ref_tiny("deep_chain").meta,
                bounds={**built.meta.bounds, "n_jobs_max": 0})))


@pytest.mark.parametrize("scen", sorted(TINY))
def test_scheduler_opts_equal_reference(scen):
    for sched in sorted(ref.available_schedulers()):
        assert scenarios.scheduler_opts(sched, tiny(scen).meta) == \
            ref_scenarios.scheduler_opts(sched, ref_tiny(scen).meta)


@pytest.mark.parametrize("seed", SEEDS)
def test_strip_releases_equals_reference(seed):
    got = scenarios.build("online_poisson", seed=seed, **MID["online_poisson"])
    want = ref_scenarios.build("online_poisson", seed=seed,
                               **MID["online_poisson"])
    assert any(j.release for j in got.instance.jobs)
    a = scenarios.strip_releases(got.instance)
    b = ref_scenarios.strip_releases(want.instance)
    assert_instances_equal(a, b, f"strip_releases seed {seed}")
    assert all(j.release == 0 for j in a.jobs)
    # a new instance: the built one keeps its releases
    assert any(j.release for j in got.instance.jobs)


# --- workload_stats and PAPER_STATS --------------------------------------

def test_paper_stats_equal_reference():
    assert PAPER_STATS == ref.PAPER_STATS


@pytest.mark.parametrize("size", ["tiny", "defaults"])
@pytest.mark.parametrize("scen", sorted(TINY))
def test_workload_stats_equal_reference(scen, size):
    kw = SIZES[size][scen]
    got = workload_stats(scenarios.build(scen, seed=1, **kw).instance)
    want = ref.workload_stats(ref_scenarios.build(scen, seed=1, **kw).instance)
    assert got == want
    assert [type(got[k]) for k in got] == [type(want[k]) for k in want]


def _job(mod, jid, n, edges, m=4, fill=1):
    d = np.full((m, m), fill, dtype=np.int64)
    np.fill_diagonal(d, 0)
    return mod.Job(jid, [mod.Coflow(jid, k, d.copy()) for k in range(n)],
                   edges)


# tests/test_workload_stats.py's shapes: chain, star, tree + diamond, edgeless
SHAPES = {
    "chain": [(0, 5, [(k, k + 1) for k in range(4)])],
    "star": [(0, 6, [(a, 5) for a in range(5)])],
    "tree_and_diamond": [(0, 3, [(0, 2), (1, 2)]),
                         (1, 4, [(0, 1), (0, 2), (1, 3), (2, 3)])],
    "edgeless": [(0, 2, [])],
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_workload_stats_shapes_equal_reference(shape):
    import repro_torch.core as port

    got = workload_stats(Instance(4, [_job(port, *a) for a in SHAPES[shape]]))
    want = ref.workload_stats(ref.Instance(4, [_job(ref, *a)
                                               for a in SHAPES[shape]]))
    assert got == want
    expect = {"chain": dict(dag_depth_max=4, max_fan_in=1, max_fan_out=1,
                            tree_fraction=1.0),
              "star": dict(dag_depth_max=1, max_fan_in=5, max_fan_out=1,
                           tree_fraction=1.0),
              "tree_and_diamond": dict(dag_depth_max=2, max_fan_out=2,
                                       tree_fraction=0.5,
                                       dag_depth_mean=1.5),
              "edgeless": dict(dag_depth_max=0, max_fan_in=0,
                               max_fan_out=0)}[shape]
    assert {k: got[k] for k in expect} == pytest.approx(expect)


def test_workload_stats_of_an_empty_instance_equal_reference():
    assert workload_stats(Instance(3, [])) == \
        ref.workload_stats(ref.Instance(3, []))


# --- the reference's invariant bundle, on the port ------------------------

def _assert_invariants(built, sched, seed=0):
    """tests/test_scenarios.py::_assert_invariants on the port (CPU)."""
    inst = built.instance
    opts = scenarios.scheduler_opts(sched, built.meta)
    p = plan(inst, sched, device="cpu", seed=seed, **opts)

    q = plan(inst, sched, device="cpu", seed=seed, **opts)
    assert p.twct() == q.twct()
    assert p.job_completions() == q.job_completions()

    replay = p.transcript().job_completions()
    for jid, t in p.job_completions().items():
        assert replay[jid] == pytest.approx(t, abs=1e-6), \
            f"{sched}: job {jid} reported {t} but transcript replays " \
            f"{replay[jid]}"

    verify_transcript(inst, p.transcript(),
                      check_capacity=sched.endswith("_bf"),
                      makespan=p.makespan if sched.endswith("_bf") else None)

    if not sched.endswith("_bf"):
        pd = plan(inst, sched, device="cpu", seed=seed, decompose=True,
                  **opts)
        verify_schedule(inst, pd.schedule)
        planned = p.twct()
        filled = plan(inst, sched + "_bf", device="cpu", seed=seed,
                      **opts).twct()
        assert filled <= planned * (1 + 1e-9) + 1e-9, \
            f"{sched}_bf (packet) twct {filled} > planned {planned}"
        led = backfill(p.schedule, exec="ledger").twct()
        null = backfill(p.schedule, fill=False, exec="ledger").twct()
        assert led <= null * (1 + 1e-9) + 1e-9, \
            f"{sched}_bf (ledger) twct {led} > null-backfill {null}"

    inst0 = scenarios.strip_releases(inst)
    onl = simulate_online(inst0, make_scheduler(sched, device="cpu",
                                                seed=seed, **opts),
                          device="cpu")
    off = p if built.meta.arrival == "offline" else \
        plan(inst0, sched, device="cpu", seed=seed, **opts)
    offline_twct = twct(off.transcript().job_completions(), inst0)
    assert onl.twct() == pytest.approx(offline_twct, abs=1e-6), \
        f"{sched}: online {onl.twct()} != offline {offline_twct}"
    return p


@pytest.mark.parametrize("sched", SCHEDULERS)
@pytest.mark.parametrize("scen", sorted(TINY))
def test_matrix_invariants_equal_reference(scen, sched):
    clear_caches()
    p = _assert_invariants(tiny(scen), sched)
    built = ref_tiny(scen)
    want = ref.plan(built.instance, sched, seed=0,
                    **ref_scenarios.scheduler_opts(sched, built.meta))
    assert p.twct() == want.twct(), f"{scen}/{sched}: twct differs"
    assert p.job_completions() == want.job_completions()
    if scen == "fb_like":
        golden = json.loads(GOLDEN_PATH.read_text())
        assert p.twct() == golden[sched], f"{sched}: golden twct"


def test_matrix_covers_every_registered_scheduler():
    assert SCHEDULERS == sorted(ref.available_schedulers())
    assert set(json.loads(GOLDEN_PATH.read_text())) == set(SCHEDULERS)


def test_zero_demand_child_verifies():
    """tests/test_scenarios.py's zero-demand marker case on the port."""
    d = np.zeros((4, 4), dtype=np.int64)
    d[0, 1] = 5
    job = Job(0, [Coflow(0, 0, d),
                  Coflow(0, 1, np.zeros((4, 4), dtype=np.int64))], [(0, 1)])
    inst = Instance(4, [job])
    for sched in ("gdm", "gdm_rt", "om_alg"):
        verify_transcript(inst, plan(inst, sched, device="cpu",
                                     seed=0).transcript())

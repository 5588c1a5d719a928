"""Backfilling in the port (``repro_torch.core.backfill`` and the ``*_bf``
schedulers) against the reference's (``repro.core.backfill``), on the CPU.

The same instances of the scenario registry go through ``repro.plan`` and
the port's ``plan(..., device="cpu")``: transcripts, completions, twct
and makespan must be equal.  The sweeps are float64 with every operation
in the reference's order, and their input, the plan's per-coflow
timed-matching decomposition, is integer, so equality is exact.  The
decomposition's fix-up BNA (one per merged interval with alpha > 1) runs
as one batch: ``bna_many`` on the python plan backend (held against the
reference's python backend), ``bna_decompose``'s plain version on the
pipeline (held against the reference's jit backend).  The two backends
order the edges of a coflow's rows differently (the pipeline's run-length
encoding lists them by sender), so the sweep emits the same entries in
another order: across backends a transcript is compared up to the order of
its entries and of their edges.""" 
import functools
import importlib
import json
from pathlib import Path

import numpy as np
import pytest

import repro.core as ref
from repro import scenarios
from repro.core import backend as ref_backend
from repro.core import timeline as ref_timeline
from repro_torch.core import (BackfillResult, available_schedulers, backfill,
                              cache_stats, clear_caches, fixup_pieces,
                              instance_from_arrays, instance_to_arrays, plan,
                              scheduler_options, transcript_to_arrays,
                              verify_transcript)
from repro_torch.core import pipeline, timeline
from repro_torch.core.bna import bna, support_restrict
from repro_torch.core.timeline import decompose_parts, merge_and_fix

REPO = Path(__file__).resolve().parents[1]
GOLDEN_PATH = REPO / "tests" / "goldens" / "scenario_goldens.json"
BF = ("gdm_bf", "gdm_rt_bf", "om_alg_bf")
# tiny per-scenario sizes, as tests/test_scenarios.py
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
backfill_module = importlib.import_module("repro_torch.core.backfill")


@functools.lru_cache(maxsize=None)
def _tiny(name):
    return scenarios.build(name, seed=0, **TINY[name])


def _port_instance(ref_inst):
    return instance_from_arrays(*instance_to_arrays(ref_inst))


def _canonical(entries):
    """Each entry with its edges sorted, the entries sorted: a transcript
    up to the order of its entries and of their edges."""
    out = []
    for e in entries:
        o = np.lexsort((e[5], e[4]))
        out.append((*e[:4], *(tuple(np.asarray(u)[o].tolist())
                              for u in e[4:]), *(u.dtype.str for u in e[4:])))
    return sorted(out)


def _assert_transcripts_equal(got, want, ctx, edge_order=True):
    a = transcript_to_arrays(got)
    b = transcript_to_arrays(want)
    assert len(a) == len(b), f"{ctx}: {len(a)} entries != {len(b)}"
    if not edge_order:   # the same entries and edges, in any order
        assert _canonical(a) == _canonical(b), f"{ctx}: transcripts differ"
        return
    for i, (x, y) in enumerate(zip(a, b)):
        assert x[:4] == y[:4], f"{ctx}: entry {i} {x[:4]} != {y[:4]}"
        for name, u, v in zip(("srcs", "dsts", "units"), x[4:], y[4:]):
            assert u.dtype == v.dtype and np.array_equal(u, v), \
                f"{ctx}: entry {i} {name} differs"


def _assert_bf_equal(got, want, ctx, edge_order=True):
    _assert_transcripts_equal(got.transcript(), want.transcript(), ctx,
                              edge_order)
    assert got.job_completions() == want.job_completions(), \
        f"{ctx}: completions differ"
    assert got.schedule.coflow_completions == \
        want.schedule.coflow_completions, f"{ctx}: coflow completions differ"
    assert got.twct() == want.twct(), f"{ctx}: twct differs"
    assert got.makespan == want.makespan, f"{ctx}: makespan differs"


def _ref_plan(inst, sched, plan_backend="python", **opts):
    with ref_backend.use_plan_backend(plan_backend):
        ref_backend.clear_caches()
        return ref.plan(inst, sched, seed=0, **opts)


# --------------------------------------------------------------------------
# the *_bf schedulers against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sched", BF)
@pytest.mark.parametrize("scen", sorted(TINY))
def test_bf_plan_equals_reference(scen, sched):
    """Packet executor on the CPU's default (python) plan backend, bit for
    bit against the reference's python backend; the transcript is exactly
    capacity-feasible and its makespan covers every completion."""
    built = _tiny(scen)
    opts = scenarios.scheduler_opts(sched, built.meta)
    want = _ref_plan(built.instance, sched, **opts)
    inst = _port_instance(built.instance)
    clear_caches()
    got = plan(inst, sched, device="cpu", seed=0, **opts)
    assert isinstance(got.schedule, BackfillResult)
    assert got.schedule.executor == "packet"
    _assert_bf_equal(got, want, f"{scen}/{sched}")
    verify_transcript(inst, got.transcript(), check_capacity=True,
                      makespan=got.makespan)
    assert cache_stats()["plan"]["fixup"]["scalar_bna"] == 0


@pytest.mark.parametrize("sched", BF)
@pytest.mark.parametrize("scen", sorted(TINY))
def test_bf_pipeline_equals_reference_jit_and_python(scen, sched):
    """The pipeline plan backend (``bna_decompose``'s plain version for
    the coflows and the fix-up) against the reference's jit backend, bit
    for bit, and against the port's python backend up to the order of a
    transcript entry's edges."""
    built = _tiny(scen)
    opts = scenarios.scheduler_opts(sched, built.meta)
    want = _ref_plan(built.instance, sched, "jit", **opts)
    inst = _port_instance(built.instance)
    clear_caches()
    got = plan(inst, sched, device="cpu", plan_backend="pipeline", seed=0,
               **opts)
    stats = cache_stats()
    assert stats["bna"]["steps"] == 0 and stats["bna"]["repairs"] == 0
    assert stats["plan"]["fixup"]["scalar_bna"] == 0
    _assert_bf_equal(got, want, f"{scen}/{sched}/pipeline vs jit")
    clear_caches()
    py = plan(inst, sched, device="cpu", plan_backend="python", seed=0,
              **opts)
    _assert_bf_equal(got, py, f"{scen}/{sched}/pipeline vs python",
                     edge_order=False)


@pytest.mark.parametrize("sched", ("gdm", "gdm_rt", "om_alg"))
@pytest.mark.parametrize("scen", sorted(TINY))
def test_bf_never_worse_and_ledger_monotone(scen, sched):
    """twct(packet backfill) <= twct(plan) pointwise, and the ledger
    executor no worse than its null-backfill comparator, on every cell."""
    built = _tiny(scen)
    opts = scenarios.scheduler_opts(sched, built.meta)
    inst = _port_instance(built.instance)
    clear_caches()
    p = plan(inst, sched, device="cpu", seed=0, **opts)
    planned = p.twct()
    filled = plan(inst, sched + "_bf", device="cpu", seed=0, **opts).twct()
    assert filled <= planned * (1 + 1e-9) + 1e-9, \
        f"{sched}_bf (packet) twct {filled} > planned {planned}"
    led = backfill(p.schedule, exec="ledger").twct()
    null = backfill(p.schedule, fill=False, exec="ledger").twct()
    assert led <= null * (1 + 1e-9) + 1e-9, \
        f"{sched}_bf (ledger) twct {led} > null-backfill {null}"


@pytest.mark.parametrize("exec_,fill", [("ledger", True), ("ledger", False),
                                         ("packet", False)])
@pytest.mark.parametrize("sched", ("gdm", "gdm_rt", "om_alg"))
@pytest.mark.parametrize("scen", ["fb_like_rt", "deep_chain"])
def test_backfill_executors_equal_reference(scen, sched, exec_, fill):
    built = _tiny(scen)
    opts = scenarios.scheduler_opts(sched, built.meta)
    ref_p = _ref_plan(built.instance, sched, **opts)
    want = ref.backfill(ref_p.schedule, fill=fill, exec=exec_)
    inst = _port_instance(built.instance)
    clear_caches()
    p = plan(inst, sched, device="cpu", seed=0, **opts)
    got = backfill(p, fill=fill, exec=exec_)
    assert got.executor == exec_
    _assert_transcripts_equal(got.transcript, want.transcript,
                              f"{scen}/{sched}/{exec_}/fill={fill}")
    assert got.coflow_completions == want.coflow_completions
    assert got.job_completions == want.job_completions
    assert got.twct() == want.twct() and got.makespan == want.makespan
    verify_transcript(inst, got.transcript, check_capacity=True,
                      makespan=got.makespan)


def test_bf_ledger_scheduler_option_equals_reference():
    built = _tiny("deep_chain")
    for sched in BF:
        opts = scenarios.scheduler_opts(sched, built.meta)
        want = _ref_plan(built.instance, sched, exec="ledger", **opts)
        clear_caches()
        got = plan(_port_instance(built.instance), sched, device="cpu",
                   seed=0, exec="ledger", **opts)
        assert got.schedule.executor == "ledger"
        _assert_bf_equal(got, want, f"deep_chain/{sched}/ledger")


def test_bf_plans_match_scenario_goldens():
    want = json.loads(GOLDEN_PATH.read_text())
    built = _tiny("fb_like")
    inst = _port_instance(built.instance)
    for sched in BF:
        clear_caches()
        got = plan(inst, sched, device="cpu", seed=0,
                   **scenarios.scheduler_opts(sched, built.meta))
        assert got.twct() == want[sched], f"{sched}: golden twct"


# --------------------------------------------------------------------------
# the engine's surface
# --------------------------------------------------------------------------

def test_bf_schedulers_registered_with_exec():
    names = available_schedulers()
    for sched in BF:
        assert sched in names
        base = sched[:-3]
        assert scheduler_options(sched) == scheduler_options(base) + \
            ("exec",)
        assert scheduler_options(sched) == ref.scheduler_options(sched)
    inst = _port_instance(_tiny("incast").instance)
    with pytest.raises(TypeError, match="unknown option"):
        plan(inst, "gdm_bf", device="cpu", execc="ledger")


@pytest.mark.parametrize("exec_", ["packet", "ledger"])
def test_plan_result_backfilled_equals_bf_scheduler(exec_):
    built = _tiny("shuffle_heavy")
    inst = _port_instance(built.instance)
    clear_caches()
    p = plan(inst, "gdm", device="cpu", seed=0)
    bf = p.backfilled(exec=exec_)
    assert bf.name == "gdm_bf"
    direct = plan(inst, "gdm_bf", device="cpu", seed=0, exec=exec_)
    _assert_bf_equal(bf, direct, f"backfilled({exec_})")
    assert bf.backfilled(exec=exec_) is bf
    want = ref.plan(built.instance, "gdm", seed=0).backfilled(exec=exec_)
    _assert_bf_equal(bf, want, f"backfilled({exec_}) vs reference")


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


def test_backfill_errors_as_the_reference_raises_them():
    built = _tiny("incast")
    inst = _port_instance(built.instance)
    clear_caches()
    bf = plan(inst, "gdm", device="cpu", seed=0).backfilled()
    ref_bf = ref.plan(built.instance, "gdm", seed=0).backfilled()
    pairs = [
        (lambda: bf.backfilled(exec="ledger"),
         lambda: ref_bf.backfilled(exec="ledger")),
        (lambda: backfill(bf), lambda: ref.backfill(ref_bf)),
        (lambda: backfill(bf.schedule, exec="ledger"),
         lambda: ref.backfill(ref_bf.schedule, exec="ledger")),
        (lambda: backfill(plan(inst, "gdm", device="cpu"), exec="fluid"),
         lambda: ref.backfill(ref.plan(built.instance, "gdm"),
                              exec="fluid")),
    ]
    for got, want in pairs:
        g, w = _raised(got), _raised(want)
        assert g[0] is w[0] is ValueError
        assert g[1] == w[1]


def test_zero_demand_tail_and_empty_jobs_as_the_reference():
    """Zero-demand coflows complete with their parents (and release), with
    a zero-width marker, under both executors."""
    from repro.core import Coflow, Instance, Job

    d0 = np.zeros((4, 4), dtype=np.int64)
    d0[0, 1] = 4
    d1 = np.zeros((4, 4), dtype=np.int64)
    d1[2, 3] = 4
    z = np.zeros((4, 4), dtype=np.int64)
    for jobs in ([Job(0, [Coflow(0, 0, d0), Coflow(0, 1, z.copy())],
                      [(0, 1)], weight=1.0),
                  Job(1, [Coflow(1, 0, d1)], [], weight=50.0)],
                 [Job(0, [Coflow(0, 0, z.copy())], [], release=5),
                  Job(1, [Coflow(1, 0, z.copy()), Coflow(1, 1, z.copy())],
                      [(0, 1)], release=7)]):
        ref_inst = Instance(4, jobs)
        inst = _port_instance(ref_inst)
        for exec_ in ("packet", "ledger"):
            want = ref.backfill(ref.plan(ref_inst, "om_alg").schedule,
                                exec=exec_)
            clear_caches()
            got = backfill(plan(inst, "om_alg", device="cpu").schedule,
                           exec=exec_)
            _assert_transcripts_equal(got.transcript, want.transcript,
                                      exec_)
            assert got.coflow_completions == want.coflow_completions
            assert got.makespan == want.makespan
            verify_transcript(inst, got.transcript, check_capacity=True,
                              makespan=got.makespan)


def test_cap_to_slack_fast_paths_equal_scalar_loop():
    rng = np.random.default_rng(5)
    for _ in range(200):
        m = int(rng.integers(1, 6))
        n = int(rng.integers(0, 8))
        want = rng.integers(0, 5, n).astype(np.float64)
        srcs = rng.integers(0, m, n)
        dsts = rng.integers(0, m, n)
        slack = rng.integers(0, 8, (2, m)).astype(np.float64)
        s1, s2 = slack.copy(), slack.copy()
        got = backfill_module._cap_to_slack(want.copy(), srcs, dsts, s1[0],
                                            s1[1])
        ref_got = backfill_module._cap_to_slack_scalar(
            want.copy(), srcs, dsts, s2[0], s2[1])
        assert np.array_equal(got, ref_got) and np.array_equal(s1, s2)


# --------------------------------------------------------------------------
# the batched fix-up (timeline._decompose) and the cross-part batch
# --------------------------------------------------------------------------

def _random_units(seed, m, n_units=4, n_edges=12, t_max=60, big=None):
    rng = np.random.default_rng(seed)
    units = []
    for uid in range(n_units):
        E = int(rng.integers(1, n_edges + 1))
        t0 = rng.integers(0, t_max, E)
        t1 = t0 + rng.integers(1, 25, E)
        if big is not None and uid == 0:   # one long interval past int32
            t0[:] = 0
            t1[:] = big
        s = rng.integers(0, m, E)
        r = rng.integers(0, m, E)
        cid = rng.integers(0, 3, E)
        units.append((uid, t0, t1, s, r, cid))
    return units


def _units_for(mod, raw):
    return [mod.UnitSchedule(uid, mod.EdgeIntervals(
        t0.astype(np.int64), t1.astype(np.int64), s.astype(np.int64),
        r.astype(np.int64), np.full(t0.size, uid, np.int64),
        np.full(t0.size, uid, np.int64), cid.astype(np.int64)), [])
        for uid, t0, t1, s, r, cid in raw]


def _assert_decompositions_equal(got, want, ctx):
    (gp, gc, ge), (wp, wc, we) = got, want
    assert len(gp) == len(wp), ctx
    for a, b in zip(gp, wp):
        assert (a.t0, a.dur) == (b.t0, b.dur), ctx
        for name in ("srcs", "dsts", "mult"):
            u, v = getattr(a, name), getattr(b, name)
            assert u.dtype == v.dtype and np.array_equal(u, v), ctx
    assert gc == wc, ctx
    for name in ("t0", "t1", "s", "r", "owner", "jid", "cid"):
        assert np.array_equal(getattr(ge, name), getattr(we, name)), \
            f"{ctx}: segments {name}"


@pytest.mark.parametrize("plan_backend", ["python", "pipeline"])
@pytest.mark.parametrize("seed,m,big", [(0, 5, None), (1, 9, None),
                                        (2, 20, None), (3, 4, 2**31 - 9)])
def test_batched_fixup_equals_scalar_bna_loop(monkeypatch, seed, m, big,
                                              plan_backend):
    """merge_and_fix(decompose=True) on random merges: the batched fix-up
    on the CPU equals the per-interval scalar bna loop (``device=None``)
    and the reference's decomposition; seed 3 holds an interval whose
    merged loads pass int32 (the int64 instance of the batched step)."""
    raw = _random_units(seed, m, big=big)
    want_ref = ref_timeline.merge_and_fix(_units_for(ref_timeline, raw), m,
                                          decompose=True)
    clear_caches()
    monkeypatch.setattr(pipeline, "_warned_overflow", True)
    got = merge_and_fix(_units_for(timeline, raw), m, decompose=True,
                        device="cpu", plan_backend=plan_backend)
    stats = cache_stats()["plan"]["fixup"]
    assert stats["lanes"] > 0 and stats["batches"] == 1
    assert stats["scalar_bna"] == 0
    if big is not None and plan_backend == "pipeline":
        assert stats["bucket_fallbacks"] >= 1
    assert got.device.type == "cpu" and got.plan_backend == plan_backend
    triple = (got.decomposition, got.exact_completion, got.coflow_edges)
    _assert_decompositions_equal(
        triple, (want_ref.decomposition, want_ref.exact_completion,
                 want_ref.coflow_edges), f"seed {seed} vs reference")
    scalar = timeline._decompose(np.asarray(got.events), got.merged,
                                 got.alphas, got.exp, m, device=None)
    assert cache_stats()["plan"]["fixup"]["scalar_bna"] == stats["lanes"]
    _assert_decompositions_equal(triple, scalar, f"seed {seed} vs scalar")


def test_overflow_interval_decomposes_on_the_int64_path(monkeypatch):
    """One interval of length near 2^31 whose merged loads pass int32:
    the pipeline's fix-up sends its bucket down the batched path (the
    int64 step), warns once, and its pieces equal the scalar bna's."""
    L = 2**31 - 9
    sub = np.array([[L, L], [L, 0]], np.int64)
    clear_caches()
    monkeypatch.setattr(pipeline, "_warned_overflow", False)
    with pytest.warns(RuntimeWarning, match="exceed int32"):
        (got,) = fixup_pieces([sub], "pipeline", "cpu")
    stats = cache_stats()["plan"]["fixup"]
    assert stats["bucket_fallbacks"] == 1 and stats["buckets"] == 0
    want = bna(sub)
    assert len(got) == len(want) and all(
        t1 == t2 and np.array_equal(p1, p2)
        for (t1, p1), (t2, p2) in zip(got, want))
    (py,) = fixup_pieces([sub], "python", "cpu")
    assert [(t, p.tolist()) for t, p in py] == \
        [(t, p.tolist()) for t, p in want]


def test_restricted_interval_demand_equals_support_restrict():
    rng = np.random.default_rng(11)
    for _ in range(50):
        m = int(rng.integers(1, 12))
        E = int(rng.integers(1, m * m + 1))
        keys = rng.choice(m * m, size=min(E, m * m), replace=False)
        iv = timeline._Interval(0, int(rng.integers(1, 9)), 2,
                                keys // m, keys % m,
                                rng.integers(1, 4, keys.size), {})
        dm = np.zeros((m, m), np.int64)
        dm[iv.srcs, iv.dsts] = iv.cnts * iv.l
        want = support_restrict(dm)
        got = timeline._restricted_demand(iv, m)
        for g, w in zip(got, want):
            assert (g is None and w is None) or np.array_equal(g, w)


@pytest.mark.parametrize("plan_backend", ["python", "pipeline"])
def test_cross_part_batch_equals_per_part_calls(plan_backend):
    """decompose_parts decomposes the fix-up intervals of several merges
    (the parts of a CompositeSchedule) in one batch; each part's
    coflow_edges equal its own coflow_intervals() call, and the public
    decomposition accounting stays unset, as coflow_intervals leaves it."""
    def parts():
        return [merge_and_fix(_units_for(timeline, _random_units(seed, 7)),
                              7, device="cpu", plan_backend=plan_backend)
                for seed in (4, 5, 6)]

    clear_caches()
    a, b = parts(), parts()
    decompose_parts(a)
    stats = cache_stats()["plan"]["fixup"]
    assert stats["batches"] == 1 and stats["lanes"] > 0
    for pa, pb in zip(a, b):
        ea, eb = pa.coflow_edges, pb.coflow_intervals()
        assert pa.decomposition is None and pa.exact_completion is None
        for name in ("t0", "t1", "s", "r", "owner", "jid", "cid"):
            assert np.array_equal(getattr(ea, name), getattr(eb, name))
    after = cache_stats()["plan"]["fixup"]
    assert after["lanes"] == 2 * stats["lanes"] and after["batches"] == 4


def test_bucket_past_the_byte_budget_splits_into_chunks(monkeypatch):
    """A bucket larger than the launch budget goes down in chunks, with the
    same pieces as one launch and as the scalar bna."""
    rng = np.random.default_rng(3)
    subs = []
    for _ in range(9):
        k = int(rng.integers(5, 9))
        x = rng.integers(0, 30, (k, k))
        x[:, 0] += 1
        x[0, :] += 1
        subs.append(x.astype(np.int64))
    clear_caches()
    whole = pipeline.decompose_pieces(subs, device="cpu")
    one = cache_stats()["plan"]["fixup"]["buckets"]
    clear_caches()
    lane = 4 * (2 * 8 * 8 + (8 * 8 + 16) * 9)
    monkeypatch.setattr(pipeline, "LAUNCH_BUDGET_BYTES", 3 * lane)
    split = pipeline.decompose_pieces(subs, device="cpu")
    many = cache_stats()["plan"]["fixup"]["buckets"]
    assert one == 1 and many >= 3
    for g, w, s in zip(split, whole, subs):
        want = bna(s)
        for got in (g, w):
            assert len(got) == len(want) and all(
                t1 == t2 and np.array_equal(p1, p2)
                for (t1, p1), (t2, p2) in zip(got, want))
    with pytest.raises(ValueError, match="support-restricted"):
        pipeline.decompose_pieces([np.zeros((2, 2), np.int64)], device="cpu")


def test_schedule_records_device_and_backend_and_keeps_them_when_shifted():
    built = _tiny("incast")
    inst = _port_instance(built.instance)
    clear_caches()
    p = plan(inst, "gdm", device="cpu", plan_backend="pipeline", seed=0,
             delays="spread")
    part = p.schedule.parts[0]
    assert part.device.type == "cpu" and part.plan_backend == "pipeline"
    moved = part.shifted_expanded(7)
    assert moved.device == part.device and moved.plan_backend == "pipeline"
    edges = moved.coflow_intervals()
    assert np.array_equal(edges.t0, part.coflow_intervals().t0 + 7)
    assert cache_stats()["plan"]["fixup"]["scalar_bna"] == 0


def test_fixup_leaves_the_plan_caches_alone():
    """The fix-up's interval demands are decomposed uncached: the BNA and
    edge caches and the coflow decomposition's counters do not move."""
    built = _tiny("shuffle_heavy")
    inst = _port_instance(built.instance)
    for plan_backend in ("python", "pipeline"):
        clear_caches()
        p = plan(inst, "gdm", device="cpu", plan_backend=plan_backend,
                 seed=0)
        before = cache_stats()
        backfill(p)
        after = cache_stats()
        assert after["plan"]["fixup"]["lanes"] > 0
        for key in ("hits", "misses", "size", "batch"):
            assert after["bna"][key] == before["bna"][key]
        assert after["order"] == before["order"]
        assert after["plan"]["edges"] == before["plan"]["edges"]
        assert after["plan"]["decompose"] == before["plan"]["decompose"]


def test_capacity_check_agrees_with_reference():
    """The port's verify_transcript(check_capacity=True) sweeps the event
    partition instead of scanning every entry per interval; it passes and
    fails where the reference's does, with the same message."""
    from repro.core import Coflow, Instance, Job
    from repro.core import simulator as ref_sim
    from repro.core.result import Transcript as RefTranscript
    from repro.core.result import TranscriptEntry as RefEntry
    from repro_torch.core.result import Transcript, TranscriptEntry

    def check(ref_inst, rows):
        inst = _port_instance(ref_inst)
        if rows is None:   # the port's backfilled gdm plan
            clear_caches()
            rows = [(e.jid, e.cid, e.t0, e.t1, e.srcs, e.dsts, e.units)
                    for e in plan(inst, "gdm_bf", device="cpu",
                                  seed=0).transcript().entries]
        results = []
        for fn, tr, ent, i in (
                (verify_transcript, Transcript, TranscriptEntry, inst),
                (ref_sim.verify_transcript, RefTranscript, RefEntry,
                 ref_inst)):
            try:
                fn(i, tr([ent(*r) for r in rows]), check_capacity=True)
                results.append(None)
            except AssertionError as err:
                results.append(str(err))
        return results

    a, b = check(_tiny("wide_shallow").instance, None)
    assert a is None and b is None
    d = np.zeros((3, 3), dtype=np.int64)
    d[0, 1], d[2, 1] = 4, 2
    one = Instance(3, [Job(0, [Coflow(0, 0, d)], [])])
    z = np.array([0]), np.array([1]), np.array([4.0])
    y = np.array([2]), np.array([1]), np.array([2.0])
    for rows, fails in (
            ([(0, 0, 0.0, 4.0, *z), (0, 0, 4.0, 6.0, *y)], False),
            ([(0, 0, 0.0, 2.0, *z), (0, 0, 2.0, 4.0, *y)], True),
            ([(0, 0, 0.0, 4.0, *z), (0, 0, 3.0, 5.0, *y)], True)):
        a, b = check(one, rows)
        assert a == b and (a is not None) == fails, (a, b)


def test_cached_group_block_runs_its_fixup_on_the_current_plan():
    """A spread-mode group block is cached across devices and plan
    backends; placed in a plan, it records that plan's, so the lazy fix-up
    runs where the plan runs.  The backfilled plans stay equal."""
    built = _tiny("shuffle_heavy")
    inst = _port_instance(built.instance)
    clear_caches()
    first = plan(inst, "gdm", device="cpu", plan_backend="python", seed=0,
                 delays="spread")
    again = plan(inst, "gdm", device="cpu", plan_backend="pipeline", seed=0,
                 delays="spread")
    assert cache_stats()["group"]["hits"] > 0
    assert {p.plan_backend for p in first.schedule.parts} == {"python"}
    assert {p.plan_backend for p in again.schedule.parts} == {"pipeline"}
    buckets = cache_stats()["plan"]["fixup"]["buckets"]
    _assert_bf_equal(again.backfilled(), first.backfilled(), "spread",
                     edge_order=False)
    assert cache_stats()["plan"]["fixup"]["buckets"] > buckets

"""The port's planning pipeline (src/repro_torch/core/pipeline.py, the plan
backend ``"pipeline"``) against the reference's jit plan backend
(src/repro/core/pipeline.py), on the CPU: the plain versions of the
``bna_decompose`` and ``merge_fix`` kernels, the bucket decomposition, the
RLE, the load vectors and whole plans must equal the reference's exactly
(all the arithmetic is integer).  The reference's compiled bucket program
runs under ``jax.jit`` on the CPU, its merge_fix in Pallas interpret mode,
as tests/test_pipeline.py and tests/test_kernels.py run them.  The CUDA
kernels are held against the plain versions on the card in
tests/test_torch_cuda.py."""
import functools
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core as ref
from repro import scenarios
from repro.core import backend as ref_backend
from repro.core import pipeline as ref_pipeline
from repro.core.bna import support_restrict as ref_support_restrict
from repro.core.matching import bucket_width as ref_bucket_width
from repro.kernels.merge_fix import merge_fix_step as ref_merge_fix_step
from repro.kernels.merge_fix.ref import merge_fix_ref as ref_merge_fix_ref
from repro_torch.core import (backend, cache_stats, clear_caches,
                              instance_from_arrays, instance_to_arrays,
                              make_scheduler, no_caches, plan,
                              transcript_to_arrays, verify_transcript)
from repro_torch.core import pipeline
from repro_torch.kernels.bna_decompose import bna_decompose
from repro_torch.kernels.bna_decompose.ref import (bna_decompose_ref,
                                                   tight_bucket)
from repro_torch.kernels.coflow_merge.ops import carry_words
from repro_torch.kernels.coflow_merge.ops import \
    scratch as coflow_merge_scratch
from repro_torch.kernels.merge_fix import merge_fix, merge_fix_step
from repro_torch.kernels.merge_fix.ops import scratch as merge_fix_scratch
from repro_torch.kernels.merge_fix.ref import (merge_fix_ref,
                                               merge_fix_tiled, tile_layout)

SCHEDULERS = ("gdm", "gdm_rt", "om_alg")
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


# --------------------------------------------------------------------------
# demand sets: the cases of tests/test_pipeline.py's decomposition tests
# --------------------------------------------------------------------------

def _width_bucket_demands():
    rng = np.random.default_rng(7)
    demands = [np.zeros((4, 4), np.int64),            # zero-demand coflow
               np.array([[5]], np.int64),             # 1x1 singleton
               np.zeros((1, 1), np.int64)]            # 1x1 zero
    for m in (2, 3, 7, 8, 9, 16, 17):                 # bucket cuts 8|9, 16|17
        d = rng.integers(0, 25, size=(m, m))
        d[rng.random((m, m)) > 0.5] = 0
        demands.append(d)
    demands.append(np.diag(rng.integers(1, 9, 6)))    # permutation support
    demands.append(np.eye(5, dtype=np.int64) * 3)     # another diagonal
    return demands


def _sparse_support_demands():
    rng = np.random.default_rng(11)
    demands = []
    for m, k in ((12, 2), (16, 3), (20, 5)):
        d = np.zeros((m, m), np.int64)
        rows = rng.choice(m, size=k, replace=False)
        cols = rng.choice(m, size=k, replace=False)
        for a in rows:
            for b in cols:
                if rng.random() < 0.7:
                    d[a, b] = int(rng.integers(1, 30))
        demands.append(d)
    return demands


DEMAND_SETS = {"width_buckets": _width_bucket_demands,
               "sparse_support": _sparse_support_demands}


def _buckets(demands):
    """The reference's bucket stacks for `demands`: (w, d (B_pad, w, w)
    int32, ks (B_pad,) int32, T_cap), batch padded with all-zero lanes as
    ``_decompose_bucket_jit`` pads it."""
    by_w: dict = {}
    for dem in demands:
        sub, _, _ = ref_support_restrict(np.asarray(dem, np.int64))
        if sub is not None:
            by_w.setdefault(ref_bucket_width(sub.shape[0]), []).append(sub)
    out = []
    for w, subs in sorted(by_w.items()):
        B_pad = ref_pipeline._pow2(len(subs))
        nnz = max(int((s > 0).sum()) for s in subs)
        d = np.zeros((B_pad, w, w), np.int32)
        ks = np.zeros(B_pad, np.int32)
        for i, s in enumerate(subs):
            d[i, :s.shape[0], :s.shape[0]] = s
            ks[i] = s.shape[0]
        out.append((w, d, ks, ref_pipeline._pow2(nnz + 6 * w + 8)))
    return out


@pytest.mark.parametrize("cases", sorted(DEMAND_SETS))
def test_bna_decompose_plain_equals_reference_program(cases):
    for w, d, ks, T_cap in _buckets(DEMAND_SETS[cases]()):
        fn = jax.jit(ref_pipeline._build_decompose(w, T_cap))
        want_ts, want_pc, want_D = (np.asarray(x) for x in fn(d, ks))
        ts, pc, D, n = bna_decompose(torch.from_numpy(d),
                                     torch.from_numpy(ks), T_cap)
        T = ts.shape[1]
        assert np.array_equal(ts.numpy(), want_ts[:, :T]), f"w={w}: ts"
        assert np.array_equal(pc.numpy(), want_pc[:, :T]), f"w={w}: pieces"
        assert (want_ts[:, T:] == 0).all() and (want_pc[:, T:] == -1).all()
        assert np.array_equal(D.numpy(), want_D), f"w={w}: D_final"
        assert np.array_equal(n.numpy(), (want_ts > 0).sum(axis=1))


@pytest.mark.parametrize("w,B,density", [(1, 3, 1.0), (2, 4, 0.7),
                                         (8, 5, 0.5), (16, 6, 0.3),
                                         (32, 3, 0.15)])
def test_bna_decompose_plain_equals_reference_random(w, B, density):
    """Random buckets with a full-width lane, narrower lanes and an
    all-zero lane; stored in fewer steps than a lane takes, which only
    changes memory."""
    rng = np.random.default_rng(w)
    d = np.zeros((B, w, w), np.int32)
    ks = np.zeros(B, np.int32)
    for b in range(B - 1):
        k = w if b == 0 else int(rng.integers(1, w + 1))
        x = rng.integers(0, 40, size=(k, k))
        x[rng.random((k, k)) > density] = 0
        d[b, :k, :k] = x
        ks[b] = k
    nnz = int((d > 0).sum(axis=(1, 2)).max())
    T_cap = ref_pipeline._pow2(nnz + 6 * w + 8)
    want = [np.asarray(x) for x in
            jax.jit(ref_pipeline._build_decompose(w, T_cap))(d, ks)]
    got = bna_decompose(torch.from_numpy(d), torch.from_numpy(ks), T_cap,
                        t_store=2)
    T = got[0].shape[1]
    assert np.array_equal(got[0].numpy(), want[0][:, :T])
    assert np.array_equal(got[1].numpy(), want[1][:, :T])
    assert np.array_equal(got[2].numpy(), want[2])
    assert int(got[3][B - 1]) == 0 and int(got[2][B - 1]) == 0


def test_bna_decompose_plain_equals_reference_bna_past_1024_senders():
    """A w = 2048 bucket (lanes of k = 1100 with repairs, 2048, 1500, and an
    empty one): each lane's steps equal the reference's scalar ``bna`` of
    its matrix, and the search counts add up.  About 8 s."""
    lanes = [(1100, 3), (2048, 1), (1500, 2), (0, 0)]
    d, ks, T_cap = tight_bucket(np.random.default_rng(2048), 2048, lanes)
    counts: dict = {}
    ts, pc, D, n = bna_decompose_ref(d, ks, T_cap, counts=counts)
    got = pipeline._steps_to_lists(ts, pc, ks.tolist())
    for b, (k, _) in enumerate(lanes):
        want = ref.bna(d[b, :k, :k].numpy()) if k else []
        assert len(got[b]) == len(want) == int(n[b]), f"lane {b}: steps"
        for (t1, p1), (t2, p2) in zip(got[b], want):
            assert t1 == t2 and np.array_equal(p1, p2), f"lane {b}"
    assert D.tolist() == [0] * len(lanes)
    assert counts["searches"][0] > 1100 and counts["searches"][3] == 0
    assert all(v >= s for v, s in zip(counts["visits"], counts["searches"]))


def test_bna_decompose_rejects_bad_inputs():
    d = torch.zeros((2, 4, 4), dtype=torch.int32)
    ks = torch.full((2,), 4, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        bna_decompose(d.long(), ks, 8)
    with pytest.raises(ValueError, match="ks must be"):
        bna_decompose(d, ks[:1], 8)
    with pytest.raises(ValueError, match="T_cap"):
        bna_decompose(d, ks, -1)
    before = bna_decompose.launches
    ts, pc, D, n = bna_decompose(d, ks, 8)
    assert bna_decompose.launches == before        # CPU: plain version
    assert ts.shape == (2, 0) and pc.shape == (2, 0, 4)
    assert D.tolist() == [0, 0] and n.tolist() == [0, 0]


# --------------------------------------------------------------------------
# pipeline level: decompositions, RLE, load vectors
# --------------------------------------------------------------------------

def _ref_plan_decompositions(demands):
    with ref_backend.use_plan_backend("jit"):
        return ref_pipeline._plan_decompositions(demands)


@pytest.mark.parametrize("cases", sorted(DEMAND_SETS))
def test_plan_decompositions_equal_reference(cases):
    demands = DEMAND_SETS[cases]()
    want_p, want_e = _ref_plan_decompositions(demands)
    got_p, got_e = pipeline._plan_decompositions(demands, device="cpu")
    for i, (gp, wp, ge, we) in enumerate(zip(got_p, want_p, got_e, want_e)):
        assert len(gp) == len(wp), f"demand {i}: piece count"
        for (t1, p1), (t2, p2) in zip(gp, wp):
            assert t1 == t2 and p1.dtype == p2.dtype \
                and np.array_equal(p1, p2), f"demand {i}: pieces"
        for name, a, b in zip(("t0", "t1", "s", "r"), ge, we):
            assert a.dtype == b.dtype and np.array_equal(a, b), \
                f"demand {i}: edge {name}"


@pytest.mark.parametrize("seed", range(3))
def test_rle_batch_equals_reference(seed):
    rng = np.random.default_rng(seed)
    B, T, w = 5, 12, 6
    ts = rng.integers(1, 9, size=(B, T)).astype(np.int32)
    pieces = rng.integers(-1, w, size=(B, T, w)).astype(np.int32)
    pieces[:, 3:6, :] = pieces[:, 3:4, :]           # runs across steps
    for b, n in enumerate((T, 7, 1, 0, 4)):          # lane prefixes
        ts[b, n:] = 0
        pieces[b, n:] = -1
    want = ref_pipeline._rle_batch(ts, pieces)
    got = pipeline._rle_batch(torch.from_numpy(ts), torch.from_numpy(pieces))
    for a, b in zip(got, want):
        assert a.dtype == np.int64 and np.array_equal(a, b)


def test_steps_to_lists_equals_reference():
    rng = np.random.default_rng(5)
    ts = rng.integers(1, 9, size=(3, 6)).astype(np.int32)
    pieces = rng.integers(-1, 4, size=(3, 6, 4)).astype(np.int32)
    ts[1, 2:] = 0
    ts[2, :] = 0
    ks = [4, 3, 2]
    want = ref_pipeline._steps_to_lists(ts, pieces, ks)
    got = pipeline._steps_to_lists(torch.from_numpy(ts),
                                   torch.from_numpy(pieces), ks)
    assert [len(x) for x in got] == [len(x) for x in want] == [6, 2, 0]
    for g, wnt in zip(got, want):
        for (t1, p1), (t2, p2) in zip(g, wnt):
            assert t1 == t2 and np.array_equal(p1, p2) \
                and p1.dtype == p2.dtype


@pytest.mark.parametrize("scen", ["fb_like", "incast", "dist_collectives"])
def test_instance_load_vectors_equal_reference(scen):
    built = scenarios.build(scen, seed=0, **TINY[scen])
    with ref_backend.use_plan_backend("jit"):
        want = ref_pipeline.instance_load_vectors(built.instance)
    got = pipeline.instance_load_vectors(_port_instance(built.instance),
                                         device="cpu")
    assert got.dtype == want.dtype == np.float64
    assert np.array_equal(got, want)


def test_instance_load_vectors_int32_guard_returns_none():
    from repro_torch.core import Coflow, Instance, Job

    d = np.array([[2**31 - 1, 0], [0, 1]], np.int64)
    inst = Instance(2, [Job(0, [Coflow(0, 0, d)], [], weight=1.0,
                            release=0)])
    assert pipeline.instance_load_vectors(inst, device="cpu") is None


def _ref_overflow_plan(demands):
    """The reference's overflow branch: its jit pipeline sends the bucket
    to the numpy batched decomposition (int64)."""
    ref_pipeline.clear_pipeline_caches()
    with ref_backend.use_plan_backend("jit"), \
            ref_backend.use_bna_backend("numpy"):
        return ref_pipeline._plan_decompositions(demands)


@pytest.mark.parametrize("demand", [
    [[2**31 - 1]],                                  # the smallest input
    [[2**31 - 1, 5], [3, 2**31 + 7]],               # loads past 2^31
    [[2**40, 0, 1], [0, 2**33, 2**33], [1, 2**33, 0]],
])
def test_overflow_bucket_takes_the_batched_path(monkeypatch, demand):
    """A bucket whose loads reach 2^31 - 1 leaves the bna_decompose path
    for matching._bna_core_batch on the same device and is counted in
    bucket_fallbacks, as in the reference.  The batched path stages such a
    bucket in int64 and decomposes it exactly as the reference's int64
    numpy step: the same pieces and edge intervals."""
    d = [np.array(demand, np.int64)]
    want_p, want_e = _ref_overflow_plan(d)
    clear_caches()
    monkeypatch.setattr(pipeline, "_warned_overflow", False)
    with pytest.warns(RuntimeWarning, match="exceed int32"):
        got_p, got_e = pipeline._plan_decompositions(d, device="cpu")
    stats = cache_stats()["plan"]["decompose"]
    assert stats["bucket_fallbacks"] == 1 and stats["buckets"] == 0
    assert _pieces_equal(got_p[0], want_p[0])
    assert len(got_e[0]) == len(want_e[0]) == 4
    for g, w in zip(got_e[0], want_e[0]):
        assert np.array_equal(np.asarray(g), np.asarray(w))


def _pieces_equal(got, want) -> bool:
    return len(got) == len(want) and all(
        int(t1) == int(t2) and np.array_equal(p1, p2)
        for (t1, p1), (t2, p2) in zip(got, want))


@pytest.mark.parametrize("demand", [[[2**31 - 1]],
                                    [[2**31 - 1, 5], [3, 2**31 + 7]]])
def test_overflow_demand_on_the_python_path(demand):
    """bna_many (the python plan path) stages the overflowing matrix in
    int64 and equals the reference's scalar bna."""
    from repro.core.bna import bna as ref_bna
    from repro_torch.core import bna_many

    d = np.array(demand, np.int64)
    (got,) = bna_many([d], device="cpu")
    assert _pieces_equal(got, ref_bna(d))


# --------------------------------------------------------------------------
# merge_fix (K3) plain version
# --------------------------------------------------------------------------

def _edges(seed):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(2, 30))
    E = int(rng.integers(1, 400))
    t0 = rng.integers(0, 250, E)
    t1 = t0 + rng.integers(1, 50, E)
    s = rng.integers(0, m, E)
    r = rng.integers(0, m, E)
    return np.unique(np.concatenate([t0, t1])), t0, t1, s, r, m


@pytest.mark.parametrize("seed", range(4))
def test_merge_fix_plain_equals_reference(seed):
    events, t0, t1, s, r, m = _edges(seed)
    al, de = merge_fix_step(events, t0, t1, s, r, m, device="cpu")
    for use_kernel in (True, False):
        ral, rde = ref_merge_fix_step(events, t0, t1, s, r, m,
                                      use_kernel=use_kernel, block_k=64)
        assert np.array_equal(al, ral) and np.array_equal(de, rde)
    oal, ode = ref_merge_fix_ref(events, t0, t1, s, r, m)
    assert np.array_equal(al, oal) and np.array_equal(de, ode)
    assert al.dtype == de.dtype == np.int64


def test_merge_fix_empty_and_int64_lens():
    z = np.zeros(0, np.int64)
    al, de = merge_fix_step(np.array([0], np.int64), z, z, z, z, 4,
                            device="cpu")
    ral, rde = ref_merge_fix_step(np.array([0], np.int64), z, z, z, z, 4)
    assert al.size == de.size == ral.size == rde.size == 0
    # interval lengths past int32: the reference's host int64 branch
    t0 = np.array([0, 0], np.int64)
    t1 = np.array([2**33, 2**32], np.int64)
    s = np.array([0, 1], np.int64)
    r = np.array([1, 0], np.int64)
    events = np.unique(np.concatenate([t0, t1]))
    al, de = merge_fix_step(events, t0, t1, s, r, 2, device="cpu")
    ral, rde = ref_merge_fix_step(events, t0, t1, s, r, 2)
    assert np.array_equal(al, ral) and np.array_equal(de, rde)
    assert de.dtype == np.int64 and de.max() > 2**31


def test_merge_fix_edge_count_guard_and_checks():
    E = 2**31 - 1                      # one past the last exact count
    big = np.broadcast_to(np.int64(0), (E,))      # a view, no memory
    with pytest.raises(ValueError, match="2\\^31-1"):
        merge_fix_step(np.arange(3), big, big, big, big, 2, device="cpu")
    ev = torch.arange(4)
    e = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="int64"):
        merge_fix(ev.int(), e, e, e, e, 2)
    with pytest.raises(ValueError, match="entries"):
        merge_fix(ev, e, e[:2], e, e, 2)
    before = merge_fix.launches
    got = merge_fix(ev, e, e + 1, e, e, 2)
    assert merge_fix.launches == before            # CPU: plain version
    want = merge_fix_ref(ev, e, e + 1, e, e, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _tiled_case(case):
    """(events, t0, t1, s, r, m) of K = 1003 intervals (no multiple of 7,
    32 or 128) unless the case sets its own."""
    rng = np.random.default_rng(len(case))
    m, E = 13, 700
    events = np.arange(1004, dtype=np.int64) * 3
    i0 = rng.integers(0, 1003, E)
    i1 = np.minimum(i0 + rng.integers(1, 40, E), 1003)
    if case == "si_eq_ei":            # empty activations: t0 == t1
        i1[::3] = i0[::3]
    elif case == "at_K":              # endpoints at row K (dropped)
        i1[::4] = 1003
        i0[::9] = 1003
    elif case == "empty_tiles":       # nothing in rows 200 .. 899
        i0 = np.where((i0 >= 200) & (i0 < 900), i0 % 200, i0)
        i1 = np.minimum(i0 + rng.integers(1, 40, E), 199 + (i0 >= 900) * 804)
    elif case == "one_tile":          # every edge inside rows 512 .. 543
        i0 = 512 + rng.integers(0, 16, E)
        i1 = i0 + rng.integers(0, 16, E)
    elif case == "m_1000":            # four port tiles of 512
        m = 1000
    t0, t1 = events[i0], events[i1]
    return events, t0, t1, rng.integers(0, m, E), rng.integers(0, m, E), m


@pytest.mark.parametrize("case", ["ragged", "si_eq_ei", "at_K",
                                  "empty_tiles", "one_tile", "m_1000"])
@pytest.mark.parametrize("R", [1, 7, 32, 128])
def test_merge_fix_tiled_equals_plain_and_reference(case, R):
    """The plain emulation of the kernel's tiled algorithm (bins by tile,
    a chunk-local sort, the radix-8 carry between tiles, the scan within
    each 32-row stretch) equals merge_fix_ref and the reference's
    merge_fix_step, at every tile height."""
    events, t0, t1, s, r, m = _tiled_case(case)
    assert (events.size - 1) % max(R, 2) != 0
    args = [torch.as_tensor(a) for a in (events, t0, t1, s, r)]
    got = merge_fix_tiled(*args, m, rows=R)
    want = merge_fix_ref(*args, m)
    ral, rde = ref_merge_fix_step(events, t0, t1, s, r, m,
                                  use_kernel=m < 1000, block_k=64)
    for x, y, z in zip(got, want, (ral, rde)):
        assert torch.equal(x, y) and np.array_equal(x.numpy(), z)


@pytest.mark.parametrize("knobs", [
    dict(max_bins=3),                               # bins of many tiles
    dict(max_bins=1),                               # one bin of all tiles
    dict(chunk_edges=17, port_tile=32)])            # many chunks, ports
def test_merge_fix_tiled_layout_corners(knobs):
    """The layout's corners: bins of several tiles, one bin for every
    tile, many chunks and narrow port tiles, on the ragged case with
    endpoints at K."""
    events, t0, t1, s, r, m = _tiled_case("at_K")
    args = [torch.as_tensor(a) for a in (events, t0, t1, s, r)]
    want = merge_fix_ref(*args, m)
    for R in (1, 32):
        got = merge_fix_tiled(*args, m, rows=R, **knobs)
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("K,E,m", [(12593, 267537, 150), (119256, 60000, 150),
                                   (60985, 2961141, 150), (1, 1, 2),
                                   (3000, 20000, 1000)])
def test_merge_scratch_holds_no_dense_interval_port_array(K, E, m):
    """The kernels' scratch, as the wrappers allocate it: no (K + 1) x 2m
    array.  merge_fix's is edge-sized (rows, records), bin-sized (a bucket
    table, the chunks' offsets) and the carry (the totals of 32-row tiles
    and their sums); coflow_merge's the carry alone."""
    P = 2 * m
    lay = tile_layout(K, E)
    got = {k: v.numel() for k, v in merge_fix_scratch(K, E, m,
                                                      "meta").items()}
    assert got == {"table": lay.nb + 1, "rows": 2 * E,
                   "seg": lay.C * (lay.nbins + 1),
                   "carry": carry_words(lay.T, P), "recs": max(2 * E, 1)}
    assert lay.T == -(-K // 32) and lay.nb <= 2 * (K + 1) and lay.C <= 512
    assert got["carry"] <= (K + 1) * P // 16 + 64
    cm = {k: v.numel() for k, v in coflow_merge_scratch(K, P,
                                                        "meta").items()}
    assert cm == {"carry": carry_words(-(-K // 32), P)}
    assert cm["carry"] <= (K + 1) * P // 16 + 64


def test_merge_layout_constants_match_the_kernel_sources():
    """The wrappers size the merge kernels' launches and scratch from
    Python constants that must equal the constants compiled into the
    kernels: the tile's rows and the port tile (merge_scan.cuh), the carry's
    radix, the chunks that fit a block's shared offsets and the ports a
    record holds (merge_fix.cu)."""
    from repro_torch.kernels.coflow_merge import ops as cm_ops
    from repro_torch.kernels.merge_fix import ops as mf_ops
    from repro_torch.kernels.merge_fix import ref as mf_ref

    def consts(path):
        text = (Path(cm_ops.__file__).parents[1] / path).read_text()
        return {k: int(v) for k, v in re.findall(
            r"constexpr int (k\w+) = (\d+);", text)}

    scan = consts("coflow_merge/csrc/merge_scan.cuh")
    fix = consts("merge_fix/csrc/merge_fix.cu")
    assert scan["kRows"] == mf_ref.ROWS == cm_ops._ROWS
    assert 1 << fix["kLgRows"] == scan["kRows"]
    assert scan["kPortTile"] == mf_ref.PORT_TILE
    assert 1 << scan["kRadix"] == 8   # carry_levels' and carry_words' radix
    assert fix["kMaxChunks"] == mf_ref.MAX_CHUNKS
    assert 1 << fix["kPortBits"] == mf_ops._PORT_LIMIT
    assert (mf_ref.MAX_BINS + 1) * 4 <= 48 * 1024


# --------------------------------------------------------------------------
# whole plans: port pipeline == reference jit == port python
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _tiny(name):
    return scenarios.build(name, seed=0, **TINY[name])


def _port_instance(ref_inst):
    return instance_from_arrays(*instance_to_arrays(ref_inst))


def _assert_plans_equal(got, want, ctx):
    a = transcript_to_arrays(got.transcript())
    b = transcript_to_arrays(want.transcript())
    assert len(a) == len(b), f"{ctx}: {len(a)} entries != {len(b)}"
    for i, (x, y) in enumerate(zip(a, b)):
        assert x[:4] == y[:4], f"{ctx}: entry {i} {x[:4]} != {y[:4]}"
        for u, v in zip(x[4:], y[4:]):
            assert u.dtype == v.dtype and np.array_equal(u, v), \
                f"{ctx}: entry {i} differs"
    assert got.job_completions() == want.job_completions(), ctx
    assert got.twct() == want.twct(), ctx
    assert got.makespan == want.makespan, ctx


@pytest.mark.parametrize("sched", SCHEDULERS)
@pytest.mark.parametrize("scen", sorted(TINY))
def test_pipeline_plan_equals_reference_jit_and_python(scen, sched):
    built = _tiny(scen)
    opts = scenarios.scheduler_opts(sched, built.meta)
    with ref_backend.use_plan_backend("jit"):
        ref_backend.clear_caches()
        want = ref.plan(built.instance, sched, seed=0, **opts)
    inst = _port_instance(built.instance)
    clear_caches()
    got = plan(inst, sched, device="cpu", plan_backend="pipeline", seed=0,
               **opts)
    stats = cache_stats()
    assert stats["plan"]["decompose"]["buckets"] > 0
    assert stats["bna"]["steps"] == 0 and stats["bna"]["repairs"] == 0
    _assert_plans_equal(got, want, f"{scen}/{sched}/pipeline vs jit")
    clear_caches()
    py = plan(inst, sched, device="cpu", plan_backend="python", seed=0,
              **opts)
    assert cache_stats()["plan"]["decompose"]["buckets"] == 0
    _assert_plans_equal(got, py, f"{scen}/{sched}/pipeline vs python")
    verify_transcript(inst, got.transcript())


@pytest.mark.parametrize("sched,opts", [
    ("gdm", dict(delays="spread", decompose=True)),
    ("gdm_rt", dict(nested=False)),
    ("om_alg", dict(decompose=True)),
])
def test_pipeline_plan_options_equal_reference(sched, opts):
    built = _tiny("fb_like_rt")
    with ref_backend.use_plan_backend("jit"):
        ref_backend.clear_caches()
        want = ref.plan(built.instance, sched, **opts)
    clear_caches()
    got = plan(_port_instance(built.instance), sched, device="cpu",
               plan_backend="pipeline", **opts)
    _assert_plans_equal(got, want, f"{sched}/{opts}")


@pytest.mark.parametrize("plan_backend", ["pipeline", "python"])
def test_wide_switch_plan_equals_reference(plan_backend):
    """gdm on a switch of m = 1000 ports (34 of its 277 busy ports above
    908): the port's plan on the CPU, through either path, equals the
    reference's python-path plan with its numpy alphas.  About 3 s."""
    ref_inst = ref.paper_workload(m=1000, mu_bar=2, seed=0, scale=0.01)
    with ref_backend.use_plan_backend("python"), \
            ref_backend.use_alpha_backend("numpy"):
        ref_backend.clear_caches()
        want = ref.plan(ref_inst, "gdm", seed=0)
    inst = _port_instance(ref_inst)
    clear_caches()
    got = plan(inst, "gdm", device="cpu", plan_backend=plan_backend, seed=0)
    _assert_plans_equal(got, want, f"m=1000/{plan_backend}")
    verify_transcript(inst, got.transcript())


def test_plan_backend_default_follows_device_and_is_validated():
    assert make_scheduler("gdm", device="cpu").plan_backend == "python"
    assert backend.resolve_plan_backend(None, "cuda") == "pipeline"
    assert backend.resolve_plan_backend(None, "cpu") == "python"
    assert make_scheduler("gdm", device="cpu",
                          plan_backend="pipeline").plan_backend == "pipeline"
    with pytest.raises(ValueError, match="unknown plan backend"):
        make_scheduler("gdm", device="cpu", plan_backend="jit")


def test_pipeline_caches_warm_clear_and_switch_off():
    built = _tiny("incast")
    inst = _port_instance(built.instance)
    clear_caches()
    cold = plan(inst, "gdm", device="cpu", plan_backend="pipeline", seed=0)
    edges = cache_stats()["plan"]["edges"]
    assert edges["size"] > 0 and edges["hits"] > 0
    warm = plan(inst, "gdm", device="cpu", plan_backend="pipeline", seed=0)
    _assert_plans_equal(warm, cold, "warm vs cold")
    assert cache_stats()["plan"]["decompose"]["batches"] == 1
    with no_caches():
        assert pipeline.edge_cache.maxsize == 0
        off = plan(inst, "gdm", device="cpu", plan_backend="pipeline",
                   seed=0)
        assert len(pipeline.edge_cache) == 0
    _assert_plans_equal(off, cold, "no_caches vs cached")
    assert pipeline.edge_cache.maxsize == backend.bna_cache.maxsize > 0
    clear_caches()
    assert len(pipeline.edge_cache) == 0
    assert cache_stats()["plan"]["decompose"] == {
        "launches": 0, "buckets": 0, "batches": 0, "bucket_fallbacks": 0}

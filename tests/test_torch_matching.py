"""The port's batched matching (repro_torch.core.matching.bna_many) against
the reference's: on the width / dtype / zero-demand grid of
tests/test_matching.py, every matrix's pieces must equal the reference's
``bna_many`` and its scalar ``bna`` exactly."""
import numpy as np
import pytest
import torch

from repro.core import backend as ref_backend
from repro.core import bna as ref_bna
from repro.core.matching import bna_many as ref_bna_many
from repro_torch.core import backend, bna_many, bucket_width, clear_caches
from repro_torch.core.backend import bna_pieces_many, prefetch_bna


def _assert_pieces_equal(got, want, ctx=""):
    assert len(got) == len(want), f"{ctx}: piece count {len(got)} != {len(want)}"
    for i, ((t1, p1), (t2, p2)) in enumerate(zip(got, want)):
        assert t1 == t2, f"{ctx}: piece {i} duration {t1} != {t2}"
        assert p1.dtype == p2.dtype and np.array_equal(p1, p2), \
            f"{ctx}: piece {i} matching differs"


def _random_demands(seed, n, m_max, density, hi):
    """As tests/test_matching.py: mixed widths and dtypes; density 0 gives
    all-zero demands."""
    rng = np.random.default_rng(seed)
    dtypes = (np.int64, np.int32, np.int16)
    out = []
    for i in range(n):
        m = int(rng.integers(1, m_max + 1))
        d = rng.integers(0, hi + 1, size=(m, m))
        d[rng.random((m, m)) > density] = 0
        out.append(d.astype(dtypes[i % len(dtypes)]))
    return out


@pytest.mark.parametrize("seed,n,m_max,density,hi", [
    (0, 1, 1, 1.0, 1),
    (1, 14, 12, 0.6, 50),
    (2, 9, 5, 0.0, 10),        # every demand all-zero
    (3, 12, 12, 1.0, 1),       # dense unit demands
    (4, 7, 12, 0.2, 50),       # sparse
    (5, 14, 3, 0.5, 7),        # narrow
    (6, 10, 9, 0.8, 2),
    (7, 24, 10, 0.6, 40),
])
def test_bna_many_equals_reference(seed, n, m_max, density, hi):
    demands = _random_demands(seed, n, m_max, density, hi)
    demands.append(np.zeros((4, 4), np.int64))
    got = bna_many(demands, validate=True, device="cpu")
    with ref_backend.use_bna_backend("numpy"):
        want = ref_bna_many(demands)
    for i, dem in enumerate(demands):
        _assert_pieces_equal(got[i], want[i], ctx=f"demand {i} vs bna_many")
        _assert_pieces_equal(got[i], ref_bna(np.asarray(dem, np.int64)),
                             ctx=f"demand {i} vs scalar bna")


def test_bna_many_equals_reference_pallas_interpret():
    demands = _random_demands(0, n=12, m_max=10, density=0.6, hi=40)
    got = bna_many(demands, device="cpu")
    with ref_backend.use_bna_backend("pallas"):
        want = ref_bna_many(demands)
    for i in range(len(demands)):
        _assert_pieces_equal(got[i], want[i], ctx=f"demand {i}")


def test_bna_many_wide_bucket_boundaries():
    # widths straddling the power-of-two bucket cuts (8|9, 16|17)
    rng = np.random.default_rng(3)
    demands = []
    for m in (7, 8, 9, 15, 16, 17):
        d = rng.integers(0, 20, size=(m, m))
        d[rng.random((m, m)) > 0.5] = 0
        demands.append(d)
    got = bna_many(demands, validate=True, device="cpu")
    for dem, pieces in zip(demands, got):
        _assert_pieces_equal(pieces, ref_bna(dem))


def test_bucket_width():
    assert [bucket_width(k) for k in (1, 2, 3, 4, 5, 8, 9, 16, 17)] == \
        [1, 2, 4, 4, 8, 8, 16, 16, 32]


def test_bna_many_rejects_bad_demands():
    with pytest.raises(ValueError):
        bna_many([np.array([[-1, 0], [0, 0]])], device="cpu")
    with pytest.raises(ValueError):
        bna_many([np.zeros((2, 3), np.int64)], device="cpu")


def test_bna_many_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bna_many([np.eye(3, dtype=np.int64)])


def test_bna_pieces_many_batches_only_misses_and_counts_steps():
    clear_caches()
    rng = np.random.default_rng(5)
    a, b = (rng.integers(0, 9, size=(6, 6)) for _ in range(2))
    bna_pieces_many([a], device="cpu")
    out = bna_pieces_many([a, b, b.copy()], device="cpu")
    stats = backend.cache_stats()["bna"]
    assert stats["batch"] == {"batches": 2, "hits": 1, "misses": 2,
                              "deduped": 1}
    assert stats["steps"] > 0
    _assert_pieces_equal(out[1], ref_bna(b))
    assert out[1] is out[2]
    clear_caches()
    assert backend.cache_stats()["bna"]["steps"] == 0


def test_prefetch_bna_skips_when_batch_exceeds_cache():
    clear_caches()
    prev = backend.bna_cache.maxsize
    try:
        backend.bna_cache.maxsize = 1
        rng = np.random.default_rng(0)
        prefetch_bna([rng.integers(0, 5, size=(3, 3)) for _ in range(2)],
                     device="cpu")
        assert backend.cache_stats()["bna"]["batch"]["batches"] == 0
    finally:
        backend.bna_cache.maxsize = prev
        clear_caches()


@pytest.mark.parametrize("maxsize", [0, 1])
def test_bna_pieces_miss_runs_batched_step(maxsize):
    """A demand the cache cannot hold still decomposes through the batched
    step (the kernel on a card), never a host-only path."""
    clear_caches()
    prev = backend.bna_cache.maxsize
    try:
        backend.bna_cache.maxsize = maxsize
        dem = np.random.default_rng(maxsize).integers(0, 9, size=(7, 7))
        got = backend.bna_pieces(dem, device="cpu")
        assert backend.cache_stats()["bna"]["steps"] > 0
        _assert_pieces_equal(got, ref_bna(dem))
    finally:
        backend.bna_cache.maxsize = prev
        clear_caches()

"""The port's CUDA kernels and its planning path on the card (marker
``cuda``).  Each test decides inside itself whether a card is present and
skips without one.  This file imports neither jax nor the reference, so it
also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (bna, bna_many, clear_caches, no_caches,
                              paper_workload,
                              plan, transcript_to_arrays, verify_transcript)
from repro_torch.kernels.bna_step import bna_step, stage_int32
from repro_torch.kernels.bna_step.ref import bna_step_ref
from repro_torch.kernels.coflow_merge import coflow_merge, interval_alphas
from repro_torch.kernels.coflow_merge.ref import alphas_ref

pytestmark = pytest.mark.cuda


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _random_state(rng, B, w):
    d = rng.integers(0, 40, size=(B, w, w))
    d[rng.random((B, w, w)) > 0.6] = 0
    d[0] = 0                                       # a drained matrix
    row, col = d.sum(axis=2), d.sum(axis=1)
    D = np.maximum(row.max(axis=1), col.max(axis=1))
    match = np.full((B, w), -1, dtype=np.int64)
    for i in range(B):
        perm = rng.permutation(w)
        keep = rng.random(w) < 0.8
        match[i, keep] = perm[keep]
    match[0] = -1
    return d, row, col, D, match


@pytest.mark.parametrize("B,w", [(1, 1), (37, 8), (37, 64), (256, 256),
                                 (3, 13), (5, 1024)])
def test_bna_step_kernel_equals_plain(B, w):
    dev = _card()
    a = list(stage_int32(*_random_state(np.random.default_rng(B + w), B, w),
                         dev))
    b = [x.clone() for x in a]
    before = bna_step.launches
    got = bna_step(*a)
    want = bna_step_ref(*b)
    torch.cuda.synchronize()
    assert bna_step.launches == before + 1
    assert torch.equal(got, want)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("K,P", [(1, 2), (31, 2), (33, 300), (4096, 64),
                                 (100_000, 300), (2_000, 1_000)])
def test_coflow_merge_kernel_equals_plain(K, P):
    dev = _card()
    delta = torch.as_tensor(np.random.default_rng(K).integers(
        -3, 4, size=(K, P)), dtype=torch.int32, device=dev)
    before = coflow_merge.launches
    got = coflow_merge(delta)
    torch.cuda.synchronize()
    assert coflow_merge.launches == before + 1
    assert torch.equal(got, alphas_ref(delta))


def test_interval_alphas_on_card_equal_cpu():
    _card()
    rng = np.random.default_rng(3)
    m, E = 20, 400
    t0 = rng.integers(0, 300, E)
    t1 = t0 + rng.integers(1, 60, E)
    events = np.unique(np.concatenate([t0, t1]))
    si, ei = np.searchsorted(events, t0), np.searchsorted(events, t1)
    s, r = rng.integers(0, m, E), rng.integers(0, m, E)
    K = events.size - 1
    assert np.array_equal(
        interval_alphas(si, ei, s, r, K, m, device="cuda"),
        interval_alphas(si, ei, s, r, K, m, device="cpu"))


def test_bna_many_on_card_equals_scalar_bna():
    _card()
    rng = np.random.default_rng(0)
    demands = []
    for m in (1, 3, 8, 9, 17, 40):
        d = rng.integers(0, 30, size=(m, m))
        d[rng.random((m, m)) > 0.5] = 0
        demands.append(d)
    for dem, pieces in zip(demands, bna_many(demands, device="cuda")):
        want = bna(dem)
        assert len(pieces) == len(want)
        for (t1, p1), (t2, p2) in zip(pieces, want):
            assert t1 == t2 and np.array_equal(p1, p2)


@pytest.mark.parametrize("sched", ["gdm", "gdm_rt", "om_alg"])
def test_plan_on_card_equals_cpu(sched):
    _card()
    inst = paper_workload(m=20, mu_bar=3, seed=0, scale=0.05,
                          rooted=(sched == "gdm_rt"))
    clear_caches()
    bna_step.launches = coflow_merge.launches = 0
    got = plan(inst, sched, device="cuda", seed=0)
    assert bna_step.launches > 0 and coflow_merge.launches > 0
    clear_caches()
    want = plan(inst, sched, device="cpu", seed=0)
    verify_transcript(inst, got.transcript())
    assert got.twct() == want.twct()
    assert got.job_completions() == want.job_completions()
    a = transcript_to_arrays(got.transcript())
    b = transcript_to_arrays(want.transcript())
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[:4] == y[:4]
        assert all(np.array_equal(u, v) for u, v in zip(x[4:], y[4:]))


def test_plan_without_caches_launches_bna_step_on_card():
    """No prefetch (caches off): each coflow's decomposition still runs
    the kernel."""
    _card()
    inst = paper_workload(m=20, mu_bar=3, seed=0, scale=0.05)
    clear_caches()
    want = plan(inst, "gdm", device="cuda", seed=0)
    bna_step.launches = 0
    with no_caches():
        got = plan(inst, "gdm", device="cuda", seed=0)
    assert bna_step.launches > 0
    assert got.twct() == want.twct()
    assert got.job_completions() == want.job_completions()

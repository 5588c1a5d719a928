"""The port's kernels (src/repro_torch/kernels) against the reference's
Pallas kernels: the plain PyTorch versions, which CPU tensors take, must
equal the reference's interpret-mode kernels and oracles exactly (all the
arithmetic is integer).  The CUDA kernels themselves are held against the
plain versions on the card in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bna_step.ops import bna_step_batch
from repro.kernels.bna_step.ref import bna_step_ref as ref_bna_step_ref
from repro.kernels.coflow_merge import interval_alphas as ref_interval_alphas
from repro.kernels.coflow_merge.ops import \
    edge_interval_alphas as ref_edge_interval_alphas
from repro.kernels.coflow_merge.ref import alphas_ref as ref_alphas_ref
from repro.kernels.coflow_merge.ref import build_delta as ref_build_delta
from repro_torch.kernels import resolve_device
from repro_torch.kernels.bna_step import bna_step, stage_int32
from repro_torch.kernels.bna_step.ref import bna_step_ref, unpack_step
from repro_torch.kernels.coflow_merge import (coflow_merge,
                                              edge_interval_alphas,
                                              interval_alphas)
from repro_torch.kernels.coflow_merge.ref import alphas_ref, build_delta

CPU = torch.device("cpu")
_NAMES = ("t", "piece", "d", "row", "col", "D", "invalid")


def _random_bna_state(rng, B, w):
    """As tests/test_kernels.py::_random_bna_state: demands with consistent
    row/col/D, a partial matching, and a drained all-zero matrix."""
    d = rng.integers(0, 40, size=(B, w, w))
    d[rng.random((B, w, w)) > 0.6] = 0
    d[0] = 0
    row = d.sum(axis=2)
    col = d.sum(axis=1)
    D = np.maximum(row.max(axis=1), col.max(axis=1))
    match = np.full((B, w), -1, dtype=np.int64)
    for i in range(B):
        perm = rng.permutation(w)
        keep = rng.random(w) < 0.8
        match[i, keep] = perm[keep]
    match[0] = -1
    return (d.astype(np.int64), row.astype(np.int64), col.astype(np.int64),
            D.astype(np.int64), match)


def _port_step(state, device=CPU):
    """The port's bna_step on `state`, as host int64 arrays in the
    reference's output order."""
    d, row, col, D, match = stage_int32(*state, device)
    packed = bna_step(d, row, col, D, match)
    t, Dn, piece, inv = unpack_step(packed)
    outs = (t, piece, d, row, col, Dn, inv)
    return tuple(o.cpu().numpy().astype(np.int64) for o in outs)


@pytest.mark.parametrize("B,w", [(1, 1), (3, 2), (8, 8), (17, 13), (40, 32)])
@pytest.mark.parametrize("seed", [0, 1])
def test_bna_step_plain_equals_reference_kernel(B, w, seed):
    state = _random_bna_state(np.random.default_rng(seed), B, w)
    got = _port_step(state)
    pallas = bna_step_batch(*state, interpret=True)
    oracle = ref_bna_step_ref(*state)
    for name, g, p, o in zip(_NAMES, got, pallas, oracle):
        p = np.asarray(p, dtype=np.int64)
        o = np.asarray(o, dtype=np.int64)
        assert np.array_equal(g, p), f"{name} != Pallas (B={B}, w={w})"
        assert np.array_equal(g, o), f"{name} != oracle (B={B}, w={w})"


def test_bna_step_drained_matrix_is_a_fixed_point():
    state = _random_bna_state(np.random.default_rng(0), 4, 8)
    t, piece, d, row, col, D, inv = _port_step(state)
    assert t[0] == 0 and D[0] == 0 and (piece[0] == -1).all()
    assert (d[0] == 0).all() and not inv[0].any()


def test_bna_step_cpu_tensor_takes_plain_version():
    state = _random_bna_state(np.random.default_rng(2), 5, 4)
    before = bna_step.launches
    a = stage_int32(*state, CPU)
    b = [x.clone() for x in a]
    assert torch.equal(bna_step(*a), bna_step_ref(*b))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert bna_step.launches == before, "a CPU call must not count a launch"


def test_bna_step_int32_guard_effective_size():
    d = np.zeros((1, 2, 2), np.int64)
    d[0, 0, 0] = 2**40
    row = d.sum(axis=2)
    col = d.sum(axis=1)
    D = row.max(axis=1)
    match = np.full((1, 2), -1, np.int64)
    with pytest.raises(ValueError, match="int32"):
        stage_int32(d, row, col, D, match, CPU)


def test_bna_step_int32_guard_element_count():
    B, w = 2**11, 2**10          # B * w^2 = 2^31: one past the guard
    d = np.broadcast_to(np.int64(0), (B, w, w))   # a view, no memory
    row = np.broadcast_to(np.int64(0), (B, w))
    D = np.zeros(B, np.int64)
    with pytest.raises(ValueError, match="element count"):
        stage_int32(d, row, row, D, row, CPU)


def test_bna_step_rejects_bad_inputs():
    d, row, col, D, match = stage_int32(
        *_random_bna_state(np.random.default_rng(0), 2, 4), CPU)
    with pytest.raises(TypeError, match="int32"):
        bna_step(d.long(), row, col, D, match)
    with pytest.raises(ValueError, match="match"):
        bna_step(d, row, col, D, match[:, :3].contiguous())
    strided = match.t().contiguous().t()          # (2, 4), not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        bna_step(d, row, col, D, strided)


# --------------------------------------------------------------------------
# coflow_merge
# --------------------------------------------------------------------------

def _random_edges(seed):
    """As tests/test_kernels.py::test_coflow_merge_sweep."""
    rng = np.random.default_rng(seed)
    m = int(rng.integers(2, 40))
    E = int(rng.integers(1, 500))
    t0 = rng.integers(0, 300, E)
    t1 = t0 + rng.integers(1, 60, E)
    events = np.unique(np.concatenate([t0, t1]))
    s = rng.integers(0, m, E)
    r = rng.integers(0, m, E)
    return m, events, t0, t1, s, r


@pytest.mark.parametrize("seed", range(6))
def test_coflow_merge_plain_equals_reference_kernel(seed):
    m, events, t0, t1, s, r = _random_edges(seed)
    si = np.searchsorted(events, t0)
    ei = np.searchsorted(events, t1)
    K = events.size - 1
    got = interval_alphas(si, ei, s, r, K, m, device="cpu")
    pallas = ref_interval_alphas(si, ei, s, r, K, m, block_k=64,
                                 use_kernel=True, interpret=True)
    oracle = np.asarray(ref_alphas_ref(ref_build_delta(
        jnp.asarray(si), jnp.asarray(ei), jnp.asarray(s), jnp.asarray(r),
        K, m)))
    assert got.dtype == np.int64
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, oracle)


@pytest.mark.parametrize("seed", range(2))
def test_coflow_merge_edge_entry_and_delta_equal_reference(seed):
    m, events, t0, t1, s, r = _random_edges(seed)
    got = edge_interval_alphas(events, t0, t1, s, r, m, device="cpu")
    want = ref_edge_interval_alphas(events, t0, t1, s, r, m,
                                    use_kernel=True, interpret=True)
    assert np.array_equal(got, want)
    si = np.searchsorted(events, t0)
    ei = np.searchsorted(events, t1)
    K = events.size - 1
    idx = [torch.as_tensor(a, dtype=torch.int64) for a in (si, ei, s, r)]
    delta = build_delta(*idx, K, m)
    ref_delta = np.asarray(ref_build_delta(
        jnp.asarray(si), jnp.asarray(ei), jnp.asarray(s), jnp.asarray(r),
        K, m))
    assert delta.dtype == torch.int32
    assert np.array_equal(delta.numpy(), ref_delta)


def test_coflow_merge_empty():
    z = np.zeros(0, int)
    got = interval_alphas(z, z, z, z, 0, 4, device="cpu")
    want = ref_interval_alphas(z, z, z, z, 0, 4, interpret=True)
    assert got.size == 0 and want.size == 0
    empty = torch.zeros((0, 8), dtype=torch.int32)
    assert coflow_merge(empty).shape == (0,)


def test_coflow_merge_edge_count_guard():
    E = 2**31 - 1                      # one past the last exact count
    big = np.broadcast_to(np.int64(0), (E,))      # a view, no memory
    with pytest.raises(ValueError, match="overflow"):
        interval_alphas(big, big, big, big, 4, 2, device="cpu")


def test_coflow_merge_cpu_tensor_takes_plain_version():
    delta = torch.as_tensor(np.random.default_rng(0).integers(
        -2, 3, size=(50, 6)), dtype=torch.int32)
    before = coflow_merge.launches
    assert torch.equal(coflow_merge(delta), alphas_ref(delta))
    assert coflow_merge.launches == before
    with pytest.raises(ValueError, match="int32"):
        coflow_merge(delta.long())


def test_resolve_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == CPU
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device("cuda")
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("meta")

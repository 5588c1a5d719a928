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
from repro_torch.kernels.bna_step import bna_step, stage_state
from repro_torch.kernels.bna_step.ref import bna_step_ref, unpack_step
from repro_torch.kernels.coflow_merge import (coflow_merge,
                                              edge_interval_alphas,
                                              interval_alphas)
from repro_torch.kernels.coflow_merge.ref import alphas_ref, build_delta
from repro.kernels.flash_attention import \
    flash_attention as ref_flash_attention
from repro.kernels.flash_attention.ref import \
    attention_ref as ref_attention_ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

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
    d, row, col, D, match = stage_state(*state, device)
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
    a = stage_state(*state, CPU)
    b = [x.clone() for x in a]
    assert torch.equal(bna_step(*a), bna_step_ref(*b))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert bna_step.launches == before, "a CPU call must not count a launch"


def test_bna_step_int32_guard_effective_size():
    """The staging keeps int32 while max D < 2^31 - 1 (the reference's
    guard for its int32 kernel) and takes int64 past it, where the step
    equals the reference's int64 numpy step."""
    from repro.core.matching import bna_step_inplace

    d = np.zeros((2, 2, 2), np.int64)
    d[0, 0, 0] = 2**40
    d[0, 1, 1] = 2**31 + 5
    d[0, 0, 1] = 3
    d[1, 1, 0] = 9
    row, col = d.sum(axis=2), d.sum(axis=1)
    D = np.maximum(row.max(axis=1), col.max(axis=1))
    match = np.array([[0, 1], [-1, 0]], np.int64)
    staged = stage_state(d, row, col, D, match, CPU)
    assert all(x.dtype == torch.int64 for x in staged)
    below = stage_state(d[1:], row[1:], col[1:], D[1:], match[1:], CPU)
    assert all(x.dtype == torch.int32 for x in below)
    at = D.copy()
    at[:] = 2**31 - 1
    assert stage_state(d, row, col, at, match, CPU)[0].dtype == torch.int64

    packed = bna_step(*staged)
    t, Dn, piece, inv = unpack_step(packed)
    want = [x.copy() for x in (d, row, col)]
    wt, wpiece, wD, winv = bna_step_inplace(*want, D, match)
    assert packed.dtype == torch.int64
    assert np.array_equal(t.numpy(), wt) and np.array_equal(Dn.numpy(), wD)
    assert np.array_equal(piece.numpy(), wpiece)
    assert np.array_equal(inv.numpy().astype(bool), winv)
    for got, w in zip(staged[:3], want):
        assert np.array_equal(got.numpy(), w)


@pytest.mark.parametrize("B,w", [(1, 1), (5, 4), (17, 13)])
@pytest.mark.parametrize("seed", [0, 1])
def test_bna_step_int64_plain_equals_reference_numpy_step(B, w, seed):
    """States with demands past 2^31 stage int64; one step equals the
    reference's int64 numpy step on the same state."""
    from repro.core.matching import bna_step_inplace

    d, row, col, D, match = _random_bna_state(np.random.default_rng(seed),
                                              B, w)
    d = d * (2**33 + 1)
    row, col = d.sum(axis=2), d.sum(axis=1)
    D = np.maximum(row.max(axis=1), col.max(axis=1))
    got = _port_step((d, row, col, D, match))
    want = [x.copy() for x in (d, row, col)]
    wt, wpiece, wD, winv = bna_step_inplace(*want, D, match)
    for name, g, o in zip(_NAMES, got, (wt, wpiece, *want, wD, winv)):
        assert np.array_equal(g, np.asarray(o, np.int64)), name


@pytest.mark.parametrize("past_int32", [False, True])
def test_bna_step_plain_equals_reference_numpy_step_past_1024_senders(
        past_int32):
    """w = 2048, more senders than a CUDA block has threads: one step of
    the int32 (and, with demands past 2^31, the int64) plain version equals
    the reference's numpy step.  Under 1 s each."""
    from repro.core.matching import bna_step_inplace

    d, row, col, D, match = _random_bna_state(np.random.default_rng(2048),
                                              2, 2048)
    if past_int32:
        d = d * (2**33 + 1)
        row, col = d.sum(axis=2), d.sum(axis=1)
        D = np.maximum(row.max(axis=1), col.max(axis=1))
    staged = stage_state(d, row, col, D, match, CPU)
    assert staged[0].dtype == (torch.int64 if past_int32 else torch.int32)
    got = _port_step((d, row, col, D, match))
    want = [x.copy() for x in (d, row, col)]
    wt, wpiece, wD, winv = bna_step_inplace(*want, D, match)
    for name, g, o in zip(_NAMES, got, (wt, wpiece, *want, wD, winv)):
        assert np.array_equal(g, np.asarray(o, np.int64)), name


def test_bna_step_rejects_bad_inputs():
    d, row, col, D, match = stage_state(
        *_random_bna_state(np.random.default_rng(0), 2, 4), CPU)
    with pytest.raises(TypeError, match="int32"):
        bna_step(d.long(), row, col, D, match)
    with pytest.raises(TypeError, match="int32 or int64"):
        bna_step(d.short(), row.short(), col.short(), D.short(),
                 match.short())
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


def test_coflow_merge_plain_equals_reference_numpy_alphas_at_m_1000():
    """A switch of m = 1000 ports (2m = 2000 columns, past the 908 ports
    whose scan tile once overflowed a block's shared memory): the plain
    version's alphas equal the reference's numpy oracle.  About 2 s."""
    from repro.core.timeline import EdgeIntervals, _alphas_vectorized

    rng = np.random.default_rng(1000)
    m, E = 1000, 20_000
    t0 = rng.integers(0, 10**6, E)
    t1 = t0 + rng.integers(1, 5000, E)
    s, r = rng.integers(0, m, E), rng.integers(0, m, E)
    s[:2], r[:2] = m - 1, m - 1                   # the last ports carry
    events = np.unique(np.concatenate([t0, t1]))
    got = edge_interval_alphas(events, t0, t1, s, r, m, device="cpu")
    want = _alphas_vectorized(events, EdgeIntervals(t0, t1, s, r), m)
    assert got.dtype == np.int64
    assert np.array_equal(got, want)


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


# --------------------------------------------------------------------------
# flash_attention (K4) plain version
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [
    (1, 2, 2, 16, 16, 32),    # MHA square
    (2, 4, 2, 33, 33, 24),    # GQA, ragged seq
    (1, 8, 2, 64, 128, 48),   # cross-length (prefill-with-prefix)
    (1, 4, 1, 1, 96, 64),     # decode shape (q_len = 1)
    (1, 4, 4, 48, 48, 128),   # head dim 128
])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 4e-2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_equals_reference(shape, dtype, tol, causal):
    """The reference sweep (tests/test_kernels.py::test_flash_attention_sweep):
    the port's plain version against the reference's Pallas kernel in
    interpret mode and its oracle, on the same inputs; compared in float32
    (bfloat16 inputs: both round their float32 result to bfloat16, so they
    may differ by an ulp of the output)."""
    B, Hq, Hkv, Sq, Sk, d = shape
    rng = np.random.default_rng(Sq * d + causal)
    arrays = [rng.normal(size=s).astype(np.float32) for s in
              ((B, Hq, Sq, d), (B, Hkv, Sk, d), (B, Hkv, Sk, d))]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    tq, tk, tv = (torch.as_tensor(a).to(tdt) for a in arrays)
    before = flash_attention.launches
    got = flash_attention(tq, tk, tv, causal=causal)
    assert flash_attention.launches == before, "a CPU call counts no launch"
    assert got.dtype == tdt and got.shape == tq.shape
    got = got.float().numpy()
    pallas = ref_flash_attention(jq, jk, jv, causal=causal, block_q=16,
                                 block_k=16, interpret=True)
    oracle = ref_attention_ref(jq, jk, jv, causal=causal)
    for want in (pallas, oracle):
        assert np.abs(got - np.asarray(want, np.float32)).max() < tol
    assert torch.equal(attention_ref(tq, tk, tv, causal=causal),
                       flash_attention(tq, tk, tv, causal=causal))


def _blocked_attention_bf16(q, k, v, causal, scale, block_q=128,
                            block_k=32):
    """The bfloat16 path of kernels/flash_attention in plain torch: q tiles
    of block_q rows against k tiles of block_k keys, S = Q K^T from bf16
    operands with float32 sums, the online softmax in base 2 on float32
    scores (keys masked with -1e30, whole causal tiles past the q tile
    skipped), P rounded to bfloat16 before P V, float32 accumulators, the
    output divided by the denominator and rounded to bfloat16."""
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(Hq // Hkv, dim=1)
    vf = v.float().repeat_interleave(Hq // Hkv, dim=1)
    qf = q.float()
    c = scale * 1.4426950408889634
    out = torch.empty((B, Hq, Sq, d))
    for q0 in range(0, Sq, block_q):
        q1 = min(Sq, q0 + block_q)
        qi = torch.arange(q0, q1)
        m = torch.full((B, Hq, q1 - q0), -1e30)
        den = torch.zeros((B, Hq, q1 - q0))
        acc = torch.zeros((B, Hq, q1 - q0, d))
        k_end = min(Sk, max(0, q1 - 1 + Sk - Sq + 1)) if causal else Sk
        for k0 in range(0, k_end, block_k):
            kj = torch.arange(k0, min(Sk, k0 + block_k))
            s = qf[:, :, q0:q1] @ kf[:, :, kj].transpose(-1, -2)
            ok = qi[:, None] + (Sk - Sq) >= kj[None, :] if causal else \
                torch.ones((q1 - q0, len(kj)), dtype=torch.bool)
            s = torch.where(ok, s * c, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            den = den * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] \
                + p.bfloat16().float() @ vf[:, :, kj]
            m = m_new
        out[:, :, q0:q1] = acc / torch.where(den == 0, 1.0, den)[..., None]
    return out.bfloat16()


@pytest.mark.parametrize("Sq,Sk", [(384, 512), (512, 512), (200, 333)])
def test_blocked_attention_with_bf16_p_within_attn_tol(Sq, Sk):
    """qwen3-1.7b's head shape (Hq=16, Hkv=8, d=128), causal: the kernel's
    blocked online softmax with P rounded to bf16 stays within the card
    check's 4e-2 of attention_ref on the same bf16 inputs."""
    rng = np.random.default_rng(Sq + Sk)
    q, k, v = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
               .bfloat16() for s in ((1, 16, Sq, 128), (1, 8, Sk, 128),
                                     (1, 8, Sk, 128)))
    scale = 128 ** -0.5
    got = _blocked_attention_bf16(q, k, v, True, scale)
    want = attention_ref(q, k, v, causal=True, scale=scale)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert float((got.float() - want.float()).abs().max()) < 4e-2
    # P in bf16 is a real rounding: the float32-P version reads differently
    exact = attention_ref(q.float(), k.float(), v.float(), causal=True,
                          scale=scale)
    assert float((got.float() - exact).abs().max()) > 0


def test_flash_attention_checks_shapes_as_reference():
    q = torch.zeros((1, 4, 8, 16))
    k = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="shapes disagree"):
        flash_attention(q, k, k[:, :, :4])
    with pytest.raises(ValueError, match="shapes disagree"):
        flash_attention(q, k[..., :8], k[..., :8])
    with pytest.raises(ValueError, match="GQA"):
        flash_attention(q, torch.zeros((1, 3, 8, 16)),
                        torch.zeros((1, 3, 8, 16)))
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q, k.bfloat16(), k)


def test_resolve_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == CPU
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device("cuda")
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("meta")


# ---------------------------------------------------------------------------
# int32 launch guards: every extent a wrapper hands to a ctypes.c_int
# argument raises past 2^31 - 1 (ctypes would wrap it without a word),
# before any device is touched; ``meta`` tensors carry the shapes with no
# memory behind them
# ---------------------------------------------------------------------------

_BIG = 2**31             # one past the largest C int


def _meta(*shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _guard_bna_step():
    B = _BIG
    bna_step(_meta(B, 1, 1), _meta(B, 1), _meta(B, 1), _meta(B),
             _meta(B, 1))


def _guard_bna_decompose_layout():
    from repro_torch.kernels.bna_decompose import ops
    ops.layout(_BIG, 8)


def _guard_bna_decompose_layout_negative():
    from repro_torch.kernels.bna_decompose import ops
    ops.layout(4, -1)


def _guard_bna_decompose_batch():
    from repro_torch.kernels.bna_decompose import ops
    ops._launch(_meta(_BIG, 1, 1), _meta(_BIG), 1, 1)


def _guard_bna_decompose_steps():
    from repro_torch.kernels.bna_decompose import ops
    ops._launch(_meta(2, 4, 4), _meta(2), _BIG, 1)


def _guard_coflow_merge():
    coflow_merge(_meta(1, _BIG))


def _merge_fix_args():
    ev = torch.tensor([0, 5, 9], dtype=torch.int64)
    e = torch.tensor([0], dtype=torch.int64)
    return ev, e, e + 5, e, e


def _guard_merge_fix_ports():
    from repro_torch.kernels.merge_fix import merge_fix
    merge_fix(*_merge_fix_args(), _BIG)


def _guard_merge_fix_tiling():
    from repro_torch.kernels.merge_fix import ops
    from repro_torch.kernels.merge_fix.ref import TileLayout
    real = ops.tile_layout
    ops.tile_layout = lambda K, E: TileLayout(1, 0, 1, 1, _BIG, 1)
    try:
        ops.merge_fix(*_merge_fix_args(), 4)
    finally:
        ops.tile_layout = real


def _qkv(Sq):
    f = torch.float32
    return _meta(1, 1, Sq, 8, dtype=f), _meta(1, 1, 4, 8, dtype=f), \
        _meta(1, 1, 4, 8, dtype=f)


def _guard_flash_attention():
    flash_attention(*_qkv(_BIG))


def _guard_attn_bwd_prep():
    from repro_torch.kernels.flash_attention import attn_bwd_prep
    o = _meta(_BIG, 1, 1, 8, dtype=torch.float32)
    attn_bwd_prep(o, o)


def _guard_attn_bwd(which):
    from repro_torch.kernels.flash_attention import ops
    q, k, v = _qkv(_BIG)
    rows = _meta(1, 1, _BIG, dtype=torch.float32)
    getattr(ops, which)(q, k, v, q, rows, rows, causal=True, scale=1.0)


def _ssd(S, dtype=torch.float32):
    return (_meta(1, S, 2, 4, dtype=dtype), _meta(1, S, 2, dtype=dtype),
            _meta(1, S, 1, 4, dtype=dtype), _meta(1, S, 1, 4, dtype=dtype))


def _guard_ssd_scan():
    from repro_torch.kernels.ssd_scan import ssd_scan
    # S itself fits a C int; padded to a chunk it would not
    ssd_scan(*_ssd(2**31 - 100))


def _guard_ssd_bwd_state(S, chunk):
    from repro_torch.kernels.ssd_scan import ssd_bwd_state
    x, a, b, c = _ssd(S)
    ssd_bwd_state(c, x, a, _meta(1, 1, 2, dtype=torch.float32), chunk=chunk)


def _guard_ssd_bwd_chunk(S, chunk):
    from repro_torch.kernels.ssd_scan import ssd_bwd_chunk
    x, a, b, c = _ssd(S)
    st = _meta(1, 1, 2, 4, 4, dtype=torch.float32)
    ssd_bwd_chunk(x, a, a, b, c, x, st, st, chunk=chunk)


@pytest.mark.parametrize("call", [
    _guard_bna_step, _guard_bna_decompose_layout,
    _guard_bna_decompose_layout_negative, _guard_bna_decompose_batch,
    _guard_bna_decompose_steps, _guard_coflow_merge, _guard_merge_fix_ports,
    _guard_merge_fix_tiling, _guard_flash_attention, _guard_attn_bwd_prep,
    lambda: _guard_attn_bwd("attn_bwd_dkdv"),
    lambda: _guard_attn_bwd("attn_bwd_dq"), _guard_ssd_scan,
    lambda: _guard_ssd_bwd_state(_BIG, 4),
    lambda: _guard_ssd_bwd_state(8, 4096),
    lambda: _guard_ssd_bwd_chunk(_BIG, 4),
    lambda: _guard_ssd_bwd_chunk(8, 0),
], ids=["bna_step", "bna_decompose_layout", "bna_decompose_layout_negative",
        "bna_decompose_batch", "bna_decompose_steps", "coflow_merge",
        "merge_fix_ports", "merge_fix_tiling", "flash_attention",
        "attn_bwd_prep", "attn_bwd_dkdv", "attn_bwd_dq", "ssd_scan",
        "ssd_bwd_state_extent", "ssd_bwd_state_chunk", "ssd_bwd_chunk_extent",
        "ssd_bwd_chunk_chunk"])
def test_int32_launch_guard_raises(call):
    with pytest.raises(ValueError, match=r"2\^31 - 1|chunk"):
        call()


def test_int32_launch_guards_leave_the_plain_path_alone():
    """Extents inside the range keep the CPU's plain versions as before."""
    from repro_torch.kernels.merge_fix import merge_fix
    from repro_torch.kernels.merge_fix.ref import merge_fix_ref
    args = _merge_fix_args()
    for m in (1, 4, 300):
        got = merge_fix(*args, m)
        want = merge_fix_ref(*args, m)
        assert all(torch.equal(g, w) for g, w in zip(got, want))

"""The port's CUDA kernels and its planning path on the card (marker
``cuda``).  Each test decides inside itself whether a card is present and
skips without one.  This file imports neither jax nor the reference, so it
also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (bna, bna_many, cache_stats, clear_caches,
                              no_caches, paper_workload, plan,
                              transcript_to_arrays, verify_transcript)
from repro_torch.kernels.bna_decompose import bna_decompose
from repro_torch.kernels.bna_decompose.ref import (bna_decompose_ref,
                                                   tight_bucket)
from repro_torch.kernels.bna_step import bna_step, stage_state
from repro_torch.kernels.bna_step.ref import bna_step_ref
from repro_torch.kernels.coflow_merge import coflow_merge, interval_alphas
from repro_torch.kernels.coflow_merge.ref import alphas_ref
from repro_torch.kernels.flash_attention import (attn_bwd_dkdv, attn_bwd_dq,
                                                 attn_bwd_prep,
                                                 flash_attention,
                                                 flash_attention_lse)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref)
from repro_torch.kernels.merge_fix import merge_fix
from repro_torch.kernels.merge_fix.ref import merge_fix_ref
from repro_torch.kernels.ssd_scan import (ssd_bwd_chunk, ssd_bwd_state,
                                          ssd_scan, ssd_scan_bwd)
from repro_torch.kernels.ssd_scan.ref import (pad_chunks, ssd_bwd_chunk_ref,
                                              ssd_bwd_ref, ssd_bwd_state_ref,
                                              ssd_ref)

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
                                 (3, 13), (5, 1024), (2, 2048)])
def test_bna_step_kernel_equals_plain(B, w):
    dev = _card()
    a = list(stage_state(*_random_state(np.random.default_rng(B + w), B, w),
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


@pytest.mark.parametrize("B,w", [(1, 1), (37, 8), (3, 64), (4, 256),
                                 (2, 2048)])
def test_bna_step_int64_kernel_equals_plain(B, w):
    """States with effective sizes past 2^31 stage int64 and launch the
    kernel's int64 instance, equal to the plain version."""
    dev = _card()
    d, row, col, D, match = _random_state(np.random.default_rng(w), B, w)
    d = d * (2**33 + 1)
    d[-1, 0, 0] = 2**33                    # past int32 when B = 1 too
    row, col = d.sum(axis=2), d.sum(axis=1)
    D = np.maximum(row.max(axis=1), col.max(axis=1))
    a = list(stage_state(d, row, col, D, match, dev))
    assert a[0].dtype == torch.int64
    b = [x.clone() for x in a]
    before = bna_step.launches
    got = bna_step(*a)
    want = bna_step_ref(*b)
    torch.cuda.synchronize()
    assert bna_step.launches == before + 1
    assert got.dtype == torch.int64 and torch.equal(got, want)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_overflow_bucket_on_card_equals_cpu():
    """The 1 x 1 demand 2^31 - 1 takes the pipeline's overflow branch on
    the card (the int64 bna_step instance) and equals the CPU."""
    from repro_torch.core import pipeline

    _card()
    d = [np.array([[2**31 - 1]], np.int64)]
    clear_caches()
    before = bna_step.launches
    got = pipeline._plan_decompositions(d, device="cuda")
    assert bna_step.launches > before
    assert cache_stats()["plan"]["decompose"]["bucket_fallbacks"] == 1
    clear_caches()
    want = pipeline._plan_decompositions(d, device="cpu")
    assert [(t, p.tolist()) for t, p in got[0][0]] == \
        [(t, p.tolist()) for t, p in want[0][0]] == [(2**31 - 1, [0])]
    for x, y in zip(got[1][0], want[1][0]):
        assert np.array_equal(x, y)


# flash_attention: the reference sweep's shapes (B, Hq, Hkv, Sq, Sk, d),
# qwen3-1.7b's prefill and the edges of the tensor-core path: head dims 16,
# 24, 48 and 256 (tiles padded to 16, 32, 64, 256), Sq < Sk under the causal
# mask, S = 1, and S off the 128-row q tile (64 rows at d = 256) and the
# 32-key tile.  float32 to 2e-5 as the reference's test (the sums run in
# another order), bfloat16 to 4e-2 (a few ulps of the output type)
_ATTN_SHAPES = [(1, 2, 2, 16, 16, 32), (2, 4, 2, 33, 33, 24),
                (1, 8, 2, 64, 128, 48), (1, 4, 1, 1, 96, 64),
                (1, 4, 4, 48, 48, 128), (1, 16, 8, 127, 127, 128),
                (1, 2, 1, 70, 70, 256), (2, 2, 1, 40, 40, 16),
                (1, 4, 2, 100, 300, 24), (1, 2, 2, 200, 200, 48),
                (1, 16, 8, 129, 129, 128), (1, 8, 4, 257, 1000, 128),
                (1, 4, 2, 1, 1, 64), (1, 2, 1, 130, 131, 256),
                # the MoE, encoder-decoder and VLM families: whisper's
                # cross-attention (Sq = a decoder prompt, Sk = 1500 frames)
                # and encoder (MHA, d = 64), granite's 24:8 at d = 64,
                # qwen3-moe's 64:4 and llava's 3008-token prefill
                (1, 20, 20, 64, 1500, 64), (1, 20, 20, 1500, 1500, 64),
                (1, 24, 8, 300, 300, 64), (1, 64, 4, 200, 200, 128),
                (1, 32, 8, 3008, 3008, 128)]


@pytest.mark.parametrize("shape", _ATTN_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 4e-2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_equals_plain(shape, dtype, tol, causal):
    dev = _card()
    B, Hq, Hkv, Sq, Sk, d = shape
    rng = np.random.default_rng(Sq * d)
    q, k, v = (torch.as_tensor(rng.normal(size=s), dtype=dtype, device=dev)
               for s in ((B, Hq, Sq, d), (B, Hkv, Sk, d), (B, Hkv, Sk, d)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    want = attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    assert float((got.float() - want.float()).abs().max()) < tol


def test_flash_attention_kernel_reads_strided_views():
    """(B, S, H, d) tensors seen through transpose(1, 2), as
    layers.attention passes them: no copy, the output in q's layout."""
    dev = _card()
    rng = np.random.default_rng(5)
    B, S, Hq, Hkv, d = 2, 77, 8, 2, 64
    q, k, v = (torch.as_tensor(rng.normal(size=(B, S, h, d)),
                               dtype=torch.float32, device=dev)
               for h in (Hq, Hkv, Hkv))
    got = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), scale=0.1)
    want = attention_ref(q.transpose(1, 2).contiguous(),
                         k.transpose(1, 2).contiguous(),
                         v.transpose(1, 2).contiguous(), scale=0.1)
    torch.cuda.synchronize()
    assert got.transpose(1, 2).is_contiguous()
    assert float((got - want).abs().max()) < 2e-5


@pytest.mark.parametrize("misalign", [0, 1])
def test_flash_attention_bf16_kernel_reads_strided_views(misalign):
    """The bf16 (tensor-core) path on transpose(1, 2) views: 16-byte
    aligned rows go by cp.async; a view one element into its storage is
    copied element by element.  Both within 4e-2 of the plain version."""
    dev = _card()
    rng = np.random.default_rng(6)
    B, S, Hq, Hkv, d = 2, 150, 8, 2, 64

    def view(h):
        flat = torch.as_tensor(rng.normal(size=B * S * h * d + misalign),
                               dtype=torch.bfloat16, device=dev)
        return flat[misalign:].view(B, S, h, d).transpose(1, 2)

    q, k, v = view(Hq), view(Hkv), view(Hkv)
    assert (q.data_ptr() % 16 == 0) == (misalign == 0)
    got = flash_attention(q, k, v)
    want = attention_ref(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert float((got.float() - want.float()).abs().max()) < 4e-2


def test_flash_attention_both_paths_on_one_input():
    """The float32 (FMA) and bfloat16 (tensor-core) paths on the same
    values at qwen3-1.7b's head shape: each within its own tolerance of the
    plain version in its type."""
    dev = _card()
    rng = np.random.default_rng(8)
    arrays = [rng.normal(size=s) for s in ((1, 16, 300, 128),
                                           (1, 8, 300, 128),
                                           (1, 8, 300, 128))]
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 4e-2)):
        q, k, v = (torch.as_tensor(a, dtype=dtype, device=dev)
                   for a in arrays)
        got = flash_attention(q, k, v)
        want = attention_ref(q, k, v)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        assert float((got.float() - want.float()).abs().max()) < tol


def test_flash_attention_kernel_refuses_what_it_does_not_take():
    dev = _card()
    q = torch.zeros((1, 2, 4, 320), device=dev)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="head dim <= 256"):
        flash_attention(q, q, q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q[..., :8].half(), q[..., :8].half(),
                        q[..., :8].half())
    assert flash_attention.launches == before


# K4's backward: the families' shapes (d 64 and 128; GQA 16:8, 24:8, 32:8,
# 64:4 and MHA 20:20), S in {1, 127, 128, 129}, Sq != Sk both ways (Sq > Sk
# causal: rows that see no key), d not a multiple of 16
_BWD_SHAPES = [(1, 16, 8, 1, 1, 128), (1, 16, 8, 127, 127, 128),
               (1, 16, 8, 128, 128, 128), (2, 16, 8, 129, 129, 128),
               (1, 24, 8, 300, 300, 64), (1, 32, 8, 257, 257, 128),
               (1, 64, 4, 200, 200, 128), (1, 20, 20, 64, 1500, 64),
               (1, 20, 20, 150, 150, 64), (2, 4, 2, 33, 33, 24),
               (1, 8, 2, 64, 128, 48), (1, 4, 2, 100, 40, 32),
               (1, 4, 1, 1, 96, 64), (1, 4, 2, 70, 70, 40)]
_BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 4e-2}   # of max |grad|


def _sees_a_key(Sq, Sk, causal, dev):
    if not causal:
        return torch.ones(Sq, dtype=torch.bool, device=dev)
    return torch.arange(Sq, device=dev) + (Sk - Sq) >= 0


def _bwd_case(shape, dtype, causal, seed, dev):
    B, Hq, Hkv, Sq, Sk, d = shape
    rng = np.random.default_rng(seed)
    q, k, v = (torch.as_tensor(rng.normal(size=sz), dtype=dtype,
                               device=dev).requires_grad_()
               for sz in ((B, Hq, Sq, d), (B, Hkv, Sk, d), (B, Hkv, Sk, d)))
    dout = torch.as_tensor(rng.normal(size=(B, Hq, Sq, d)), dtype=dtype,
                           device=dev)
    return q, k, v, dout


def _staged():
    return attn_bwd_dkdv.staged, attn_bwd_dq.staged


def _expected_staged(Sq, dtype):
    """The staged copies a bf16 backward makes of contiguous operands:
    none of q, k, v, dout (TMA reads them as they lie); dk/dv's lse and D
    where their rows (Sq float32 values) are not a multiple of 16 bytes."""
    if dtype != torch.bfloat16:
        return 0, 0
    return (0 if Sq % 4 == 0 else 2), 0


def _assert_grads_close(got, want, sees, tol):
    dq, dk, dv = got
    wq, wk, wv = want
    for g, w in ((dq, wq), (dk, wk), (dv, wv)):
        assert g.dtype == w.dtype and g.shape == w.shape
    scale = max(float(w.float().abs().max()) for w in want) or 1.0
    errs = [float((dq[:, :, sees].float() - wq[:, :, sees].float())
                  .abs().max()) if bool(sees.any()) else 0.0,
            float((dk.float() - wk.float()).abs().max()),
            float((dv.float() - wv.float()).abs().max())]
    assert max(errs) <= tol * scale, (errs, scale)
    assert not bool(dq[:, :, ~sees].any())      # rows that see no key: 0


@pytest.mark.parametrize("shape", _BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_kernels_equal_plain(shape, dtype, causal):
    """K4's autograd on the card launches the three backward kernels once
    each, and dq, dk, dv equal attention_bwd_ref within 2e-5 (float32) or
    4e-2 (bfloat16) of the largest |gradient|; dq is 0 on rows that see no
    key."""
    dev = _card()
    q, k, v, dout = _bwd_case(shape, dtype, causal, sum(shape), dev)
    before = (flash_attention.launches, attn_bwd_prep.launches,
              attn_bwd_dkdv.launches, attn_bwd_dq.launches)
    staged = _staged()
    out = flash_attention(q, k, v, causal=causal)
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = attention_bwd_ref(q.detach(), k.detach(), v.detach(), dout,
                             causal=causal)
    torch.cuda.synchronize()
    after = (flash_attention.launches, attn_bwd_prep.launches,
             attn_bwd_dkdv.launches, attn_bwd_dq.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1]
    # the route: bf16 through the wgmma kernels, q, k, v and dout read by TMA
    # as they lie
    assert tuple(a - b for a, b in zip(_staged(), staged)) == \
        _expected_staged(shape[3], dtype)
    sees = _sees_a_key(shape[3], shape[4], causal, dev)
    _assert_grads_close(got, want, sees, _BWD_TOL[dtype])


@pytest.mark.parametrize("layout", ["bhsd", "bshd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_at_training_length(dtype, layout):
    """qwen3-1.7b's head shape at S = 4096, causal: the backward against the
    plain version, on contiguous (B, H, S, d) inputs and on (B, S, H, d)
    ones seen through transpose(1, 2) as the model passes them; bf16 reads
    both by TMA as they lie (no staged copy)."""
    dev = _card()
    shape = (1, 16, 8, 4096, 4096, 128)
    q, k, v, dout = _bwd_case(shape, dtype, True, 4096, dev)
    if layout == "bshd":
        q, k, v, dout = (x.detach().transpose(1, 2).contiguous()
                         .transpose(1, 2) for x in (q, k, v, dout))
        q, k, v = (x.requires_grad_() for x in (q, k, v))
    staged = _staged()
    out = flash_attention(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = attention_bwd_ref(q.detach(), k.detach(), v.detach(), dout)
    torch.cuda.synchronize()
    assert _staged() == staged
    _assert_grads_close(got, want, _sees_a_key(4096, 4096, True, dev),
                        _BWD_TOL[dtype])


@pytest.mark.parametrize("case", ["offset", "d20"])
def test_flash_attention_bwd_stages_what_tma_cannot_read(case):
    """bf16 operands TMA cannot describe as they lie go through a staged
    copy, counted on the wrappers, and the gradients still equal the plain
    version's within _BWD_TOL: q a view whose base is one element into its
    buffer (staged by both kernels), or a head dim of 20 (rows of 40 bytes:
    all four operands staged by both)."""
    dev = _card()
    if case == "offset":
        shape = (1, 8, 4, 200, 200, 64)
        q, k, v, dout = _bwd_case(shape, torch.bfloat16, True, 7, dev)
        buf = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=dev)
        q = buf[1:].view(q.shape).copy_(q.detach()).requires_grad_()
        want_staged = (1, 1)
    else:
        shape = (2, 4, 2, 96, 96, 20)
        q, k, v, dout = _bwd_case(shape, torch.bfloat16, True, 8, dev)
        want_staged = (4, 4)
    staged = _staged()
    out = flash_attention(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = attention_bwd_ref(q.detach(), k.detach(), v.detach(), dout)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_staged(), staged)) == want_staged
    _assert_grads_close(got, want, _sees_a_key(shape[3], shape[4], True, dev),
                        _BWD_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_lse_equals_plain(dtype, causal):
    """The forward's row log-sum-exp: within 1e-4 of the plain version on
    rows that see a key, -inf on the others."""
    dev = _card()
    shape = (1, 8, 4, 100, 40, 64)
    q, k, v, _ = _bwd_case(shape, dtype, causal, 3, dev)
    _, lse = flash_attention_lse(q.detach(), k.detach(), v.detach(),
                                 causal=causal)
    want = attention_lse_ref(q.detach(), k.detach(), causal=causal)
    torch.cuda.synchronize()
    sees = _sees_a_key(100, 40, causal, dev)
    assert lse.dtype == torch.float32 and lse.shape == (1, 8, 100)
    assert float((lse[:, :, sees] - want[:, :, sees]).abs().max()) < 1e-4
    assert bool(torch.isneginf(lse[:, :, ~sees]).all())


def test_flash_attention_bwd_is_deterministic_and_keeps_layouts():
    """(B, S, H, d) views through transpose(1, 2), as layers.attention
    passes them: the gradients come back in the same memory layout, and two
    runs give the same bits."""
    dev = _card()
    rng = np.random.default_rng(11)
    B, S, Hq, Hkv, d = 2, 333, 16, 8, 128
    base = [torch.as_tensor(rng.normal(size=(B, S, h, d)),
                            dtype=torch.bfloat16, device=dev)
            for h in (Hq, Hkv, Hkv)]
    dout = torch.as_tensor(rng.normal(size=(B, S, Hq, d)),
                           dtype=torch.bfloat16, device=dev)
    runs = []
    for _ in range(2):
        leaves = [x.clone().requires_grad_() for x in base]
        out = flash_attention(*(x.transpose(1, 2) for x in leaves))
        out.transpose(1, 2).backward(dout)
        runs.append([x.grad for x in leaves])
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert a.is_contiguous() and torch.equal(a, b)
    want = attention_bwd_ref(*(x.transpose(1, 2) for x in base),
                             dout.transpose(1, 2))
    _assert_grads_close([g.transpose(1, 2) for g in runs[0]], want,
                        _sees_a_key(S, S, True, dev), 4e-2)


def test_flash_attention_serve_path_writes_no_lse():
    """Without a gradient (inference mode, or no input that requires one)
    K4 runs its forward alone: no backward state is kept."""
    dev = _card()
    q = torch.randn((1, 4, 64, 64), device=dev, requires_grad=True)
    with torch.inference_mode():
        out = flash_attention(q.detach(), q.detach(), q.detach())
    assert out.grad_fn is None
    out = flash_attention(q, q, q)
    assert out.grad_fn is not None


# K5's backward: (B, S, H, G, N, P, L).  mamba2-2.7b's heads at S in {1,
# 127, 128, 129, 4096}, jamba-1.5-large's full-width heads (H 256 in 8
# groups) at a small B S, the smoke configs' (N 16, P 8, L 16) and G = 3.
# Tolerances of each output's own largest |value| (dx, da, db and dc apart:
# db and dc sum the group's heads and dwarf dx): float32 2e-5 (K4's
# backward's; both sum in float32 in other orders), bf16 1e-2 (set from
# readings: 3.4e-3 at most, dx at S = 4096, where the card's forward keeps
# TF32-rounded states and the gradients are rounded to bf16)
# the edges of the bf16 tensor-core kernels (csrc/ssd_scan_bwd_mma.cu):
# chunks of 64 and 48 (partial 32-column score tiles), N 64 with P 128 (the
# wide-P accumulators and one stage in flight), a group of two heads and one
# of twelve (a walk of 8 heads, then one of 4), a padded last chunk at
# mamba2's heads, N and P not multiples of 8 (element-wise staging, 16-wide
# padding)
_SSD_BWD_EDGES = [(2, 256, 16, 2, 128, 64, 64), (1, 240, 12, 4, 72, 40, 48),
                  (1, 256, 8, 1, 64, 128, 128), (2, 300, 6, 3, 128, 64, 128),
                  (1, 128, 24, 2, 64, 32, 64), (1, 257, 80, 1, 128, 64, 128),
                  (1, 100, 4, 2, 20, 12, 32)]
_SSD_BWD_SHAPES = [(1, S, 80, 1, 128, 64, 128)
                   for S in (1, 127, 128, 129, 4096)] \
    + [(1, 384, 256, 8, 128, 64, 128), (2, 24, 16, 1, 16, 8, 16),
       (2, 50, 6, 3, 16, 8, 16)] \
    + _SSD_BWD_EDGES
_SSD_BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def _ssd_bwd_inputs(shape, dtype, dev, seed):
    """x, a, b, c, dy from numpy; b and c strided views of one (B, S, 2, G,
    N) tensor, as models.ssm splits them out of one projection."""
    B, S, H, G, N, P, _ = shape
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(B, S, H, P)), dtype=dtype,
                        device=dev)
    a = torch.as_tensor(rng.uniform(0.55, 1.0, size=(B, S, H)),
                        dtype=torch.float32, device=dev)
    bc = torch.as_tensor(rng.normal(size=(B, S, 2, G, N)) * 0.3, dtype=dtype,
                         device=dev)
    dy = torch.as_tensor(rng.normal(size=(B, S, H, P)), dtype=dtype,
                         device=dev)
    return x, a, bc[:, :, 0], bc[:, :, 1], dy


def _grads_close(got, want, tol):
    """Each gradient within `tol` of its own largest |value|: dx, da, db and
    dc differ in size (db and dc sum the group's heads, 80 at mamba2), so
    one scale pooled over the four would not hold dx."""
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = float(w.float().abs().max()) or 1.0
        assert float((g.float() - w.float()).abs().max()) <= tol * scale


@pytest.mark.parametrize("shape", _SSD_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_backward_kernels_equal_plain(shape, dtype):
    """ssd_bwd_state and ssd_bwd_chunk on the card against their plain
    versions on the same inputs (the forward's kept states), and the
    autograd gradient of ssd_scan against ssd_bwd_ref: one launch of each
    wrapper a backward, each within its tolerance."""
    from repro_torch.kernels.ssd_scan.ops import _forward

    dev = _card()
    B, S, H, G, N, P, L = shape
    x, a, b, c, dy = _ssd_bwd_inputs(shape, dtype, dev, sum(shape))
    tol = _SSD_BWD_TOL[dtype]
    with torch.no_grad():
        loga, states, decay = _forward(x, a, b, c, L, True)[1]
    Lc = min(L, S)
    xp, ap, bp, cp, dyp = pad_chunks(Lc, x, a, b, c, dy)
    grads = ssd_bwd_state(cp, dyp, loga, decay, chunk=Lc)
    _grads_close([grads], [ssd_bwd_state_ref(cp, dyp, loga, decay, Lc)],
                 tol)
    af = ap.contiguous()
    _grads_close(ssd_bwd_chunk(xp, af, loga, bp, cp, dyp, states, grads,
                               chunk=Lc),
                 ssd_bwd_chunk_ref(xp, af, loga, bp, cp, dyp, states, grads,
                                   Lc), tol)
    leaves = [t.detach().clone().requires_grad_() for t in (x, a, b, c)]
    before = (ssd_bwd_state.launches, ssd_bwd_chunk.launches)
    ssd_scan(*leaves, chunk=L).backward(dy)
    torch.cuda.synchronize()
    assert (ssd_bwd_state.launches, ssd_bwd_chunk.launches) == \
        (before[0] + 1, before[1] + 1)
    _grads_close([t.grad for t in leaves],
                 ssd_bwd_ref(x, a, b, c, dy, chunk=L), tol)


def test_ssd_scan_backward_gives_the_same_bits_twice():
    """No atomics: two backwards of one input at mamba2's head shape (two
    batches, eight chunks) give the same bits, bf16 and float32."""
    from repro_torch.kernels.ssd_scan.ops import _forward

    dev = _card()
    for dtype in (torch.bfloat16, torch.float32):
        x, a, b, c, dy = _ssd_bwd_inputs((2, 1024, 80, 1, 128, 64, 128),
                                         dtype, dev, 3)
        with torch.no_grad():
            kept = _forward(x, a, b, c, 128, True)[1]
        runs = [ssd_scan_bwd(x, a, b, c, dy, *kept, chunk=128)
                for _ in range(2)]
        torch.cuda.synchronize()
        for u, v in zip(*runs):
            assert torch.equal(u, v)


def test_ssd_scan_backward_runs_the_tensor_core_kernels():
    """bf16 runs the tensor-core kernels and float32 the FMA kernels, as
    BWD_KERNELS names them: the library reports each one's name, registers
    and shared memory (the bf16 ones within 255 registers and without local
    memory at mamba2's shape and at P = 128), and the profiler sees exactly
    the named kernels run in a backward of each type."""
    import ctypes

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import load_kernel
    from repro_torch.kernels.ssd_scan import BWD_KERNELS
    from repro_torch.kernels.ssd_scan.ops import _forward

    dev = _card()
    lib = load_kernel("ssd_scan")
    lib.ssd_bwd_kernel_name.argtypes = [ctypes.c_int]
    lib.ssd_bwd_kernel_name.restype = ctypes.c_char_p
    names = {dt: {w: [lib.ssd_bwd_kernel_name(k).decode() for k in ks]
                  for w, ks in kinds.items()}
             for dt, kinds in BWD_KERNELS.items()}
    assert names[torch.bfloat16] == {
        "ssd_bwd_state": ["ssd_bwd_state_mma"],
        "ssd_bwd_chunk": ["ssd_bwd_dx_mma", "ssd_bwd_db_mma",
                          "ssd_bwd_dc_mma", "ssd_bwd_finish"]}
    assert names[torch.float32] == {
        "ssd_bwd_state": ["ssd_bwd_chunk_state", "ssd_bwd_pass"],
        "ssd_bwd_chunk": ["ssd_bwd_chunk", "ssd_bwd_group_sum"]}
    for L, N, P in ((128, 128, 64), (128, 64, 128), (16, 16, 8)):
        for ks in BWD_KERNELS[torch.bfloat16].values():
            for k in ks:
                regs, local = ctypes.c_int(), ctypes.c_int()
                smem = ctypes.c_longlong()
                assert lib.ssd_bwd_attributes(
                    k, L, N, P, ctypes.byref(regs), ctypes.byref(local),
                    ctypes.byref(smem)) == 0
                assert 0 < regs.value <= 255 and local.value == 0
                assert 0 <= smem.value <= 232448
    for dtype in (torch.bfloat16, torch.float32):
        x, a, b, c, dy = _ssd_bwd_inputs((1, 256, 16, 2, 64, 32, 128), dtype,
                                         dev, 7)
        with torch.no_grad():
            kept = _forward(x, a, b, c, 128, True)[1]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ssd_scan_bwd(x, a, b, c, dy, *kept, chunk=128)
            torch.cuda.synchronize()
        ran = {e.key for e in prof.key_averages() if "ssd_bwd" in e.key}
        want = [n for ns in names[dtype].values() for n in ns]
        for n in want:
            assert any(f"::{n}<" in k or f"::{n}(" in k for k in ran), (n, ran)
        assert len(ran) == len(want), ran


def test_ssd_scan_backward_refuses_what_it_does_not_take():
    """The backward wrappers check their operands before any launch."""
    dev = _card()
    x, a, b, c, dy = _ssd_bwd_inputs((1, 32, 4, 2, 16, 8, 16),
                                     torch.float32, dev, 0)
    loga = torch.log(a)
    decay = torch.zeros((1, 2, 4), device=dev)
    before = (ssd_bwd_state.launches, ssd_bwd_chunk.launches)
    with pytest.raises(ValueError, match="dense"):
        ssd_bwd_state(c, dy.transpose(2, 3).contiguous().transpose(2, 3),
                      loga, decay, chunk=16)
    with pytest.raises(TypeError, match="one type"):
        ssd_bwd_state(c.bfloat16(), dy, loga, decay, chunk=16)
    states = torch.zeros((1, 2, 4, 16, 8), device=dev)
    with pytest.raises(TypeError, match="float32 a"):
        ssd_bwd_chunk(x, a.double(), loga, b, c, dy, states, states,
                      chunk=16)
    with pytest.raises(TypeError, match="one type"):
        ssd_bwd_chunk(x, a, loga, b, c, dy.bfloat16(), states, states,
                      chunk=16)
    assert (ssd_bwd_state.launches, ssd_bwd_chunk.launches) == before


def test_smoke_prefill_and_serve_on_card_equal_cpu():
    """qwen3-1.7b's f32 smoke config: the prefill on the card launches K4
    once per layer, its logits and cache equal the CPU's within 1e-4, and
    a fifo serve run gives the same tokens on both devices."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm, prefill
    from repro_torch.models.lm import tree_map
    from repro_torch.serve import Request, ServeConfig, ServingEngine

    dev = _card()
    assert not torch.backends.cuda.matmul.allow_tf32   # PyTorch's default
    cfg = get_config("qwen3-1.7b").smoke()
    cpu = init_lm(cfg, torch.Generator().manual_seed(0))
    card = tree_map(lambda x: x.to(dev), cpu)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, 40)))
    before = flash_attention.launches
    lg, cache = prefill(cfg, card, toks.to(dev))
    assert flash_attention.launches == before + cfg.n_layers
    lg_c, cache_c = prefill(cfg, cpu, toks)
    assert float((lg.cpu() - lg_c).abs().max()) < 1e-4
    for name in cache_c["layers"]:
        for kv in ("k", "v"):
            assert float((cache["layers"][name][kv].cpu()
                          - cache_c["layers"][name][kv]).abs().max()) < 1e-4

    def reqs():
        rng = np.random.default_rng(1)
        return [Request(rid=i, tokens=rng.integers(1, cfg.vocab, size=6 + i),
                        max_new=5, arrival=float(i // 2)) for i in range(5)]

    outs = []
    for params in (card, cpu):
        rs = reqs()
        stats = ServingEngine(cfg, params, ServeConfig(
            slots=2, capacity=32, admission="fifo")).run(rs)
        outs.append((stats, [r.out for r in rs]))
    assert outs[0] == outs[1]
    assert outs[0][0]["completed"] == 5


def _merge_deltas(K, P, kind):
    """(K, P) int32 deltas: random in [-3, 3]; one hot 32-row tile (every
    other row 0); or every port +1 at row 0 (edges spanning all of K)."""
    rng = np.random.default_rng(K)
    if kind in ("random", "repeat"):
        return rng.integers(-3, 4, size=(K, P))
    d = np.zeros((K, P), dtype=np.int64)
    if kind == "hot":
        t = K // 64 * 32
        d[t:t + 32] = rng.integers(-3, 6, size=(min(32, K - t), P))
    else:
        d[0] = 1
        d[K // 2, ::3] = -1
    return d


@pytest.mark.parametrize("K,P,kind", [
    pytest.param(K, P, "random", id=f"{K}-{P}")
    for K, P in [(1, 2), (31, 2), (33, 300), (4096, 64), (100_000, 300),
                 (2_000, 1_000), (3_000, 2_000)]] + [
    pytest.param(1, 2_000, "random", id="K_1-2m_2000"),
    pytest.param(33, 2_000, "random", id="K_33-2m_2000"),
    pytest.param(119_288, 300, "random", id="K_119288"),
    pytest.param(40_001, 2_000, "random", id="K_40001-2m_2000"),
    pytest.param(20_000, 300, "hot", id="hot_tile"),
    pytest.param(20_000, 2_000, "hot", id="hot_tile-2m_2000"),
    pytest.param(100_000, 300, "span", id="span_all_of_K"),
    pytest.param(5_277, 300, "repeat", id="repeat_100")])
def test_coflow_merge_kernel_equals_plain(K, P, kind):
    """One pass on the radix-8 carry: tiles of 32 rows from the ticket, up
    to thousands of blocks waiting on lower tiles' totals; repeated on one
    stream, a stale completion count or ticket would show."""
    dev = _card()
    delta = torch.as_tensor(_merge_deltas(K, P, kind), dtype=torch.int32,
                            device=dev)
    want = alphas_ref(delta)
    reps = 100 if kind == "repeat" else 1
    before = coflow_merge.launches
    got = [coflow_merge(delta) for _ in range(reps)]
    torch.cuda.synchronize()
    assert coflow_merge.launches == before + reps
    assert all(torch.equal(g, want) for g in got)


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


def _assert_plans_equal(got, want):
    assert got.twct() == want.twct()
    assert got.job_completions() == want.job_completions()
    a = transcript_to_arrays(got.transcript())
    b = transcript_to_arrays(want.transcript())
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[:4] == y[:4]
        assert all(np.array_equal(u, v) for u, v in zip(x[4:], y[4:]))


@pytest.mark.parametrize("sched", ["gdm", "gdm_rt", "om_alg"])
def test_plan_on_card_equals_cpu(sched):
    """The python plan path on the card: bna_step and coflow_merge."""
    _card()
    inst = paper_workload(m=20, mu_bar=3, seed=0, scale=0.05,
                          rooted=(sched == "gdm_rt"))
    clear_caches()
    bna_step.launches = coflow_merge.launches = 0
    got = plan(inst, sched, device="cuda", plan_backend="python", seed=0)
    assert bna_step.launches > 0 and coflow_merge.launches > 0
    clear_caches()
    want = plan(inst, sched, device="cpu", seed=0)
    verify_transcript(inst, got.transcript())
    _assert_plans_equal(got, want)


@pytest.mark.parametrize("sched", ["gdm", "gdm_rt", "om_alg"])
def test_pipeline_plan_on_card_equals_cpu(sched):
    """The pipeline plan path, the card's default: bna_decompose and
    merge_fix, no host repair, no bna_step."""
    _card()
    inst = paper_workload(m=20, mu_bar=3, seed=0, scale=0.05,
                          rooted=(sched == "gdm_rt"))
    clear_caches()
    bna_step.launches = coflow_merge.launches = 0
    bna_decompose.launches = merge_fix.launches = 0
    got = plan(inst, sched, device="cuda", seed=0)
    stats = cache_stats()
    assert bna_decompose.launches > 0 and merge_fix.launches > 0
    assert bna_step.launches == 0 and coflow_merge.launches == 0
    assert stats["bna"]["repairs"] == 0
    assert stats["plan"]["decompose"]["bucket_fallbacks"] == 0
    for pb in ("pipeline", "python"):
        clear_caches()
        want = plan(inst, sched, device="cpu", plan_backend=pb, seed=0)
        _assert_plans_equal(got, want)


def test_plan_without_caches_launches_bna_step_on_card():
    """No prefetch (caches off): each coflow's decomposition still runs
    the kernel."""
    _card()
    inst = paper_workload(m=20, mu_bar=3, seed=0, scale=0.05)
    clear_caches()
    want = plan(inst, "gdm", device="cuda", plan_backend="python", seed=0)
    bna_step.launches = 0
    with no_caches():
        got = plan(inst, "gdm", device="cuda", plan_backend="python",
                   seed=0)
    assert bna_step.launches > 0
    assert got.twct() == want.twct()
    assert got.job_completions() == want.job_completions()


def _random_bucket(rng, B, w, density):
    d = np.zeros((B, w, w), np.int32)
    ks = np.zeros(B, np.int32)
    for b in range(B - 1):                          # the last lane is empty
        k = w if b == 0 else int(rng.integers(1, w + 1))
        x = rng.integers(0, 40, size=(k, k))
        x[rng.random((k, k)) > density] = 0
        d[b, :k, :k] = x
        ks[b] = k
    nnz = int((d > 0).sum(axis=(1, 2)).max())
    T_cap = 1 << (nnz + 6 * w + 8 - 1).bit_length()
    return torch.from_numpy(d), torch.from_numpy(ks), T_cap


# Lanes per block: 4 up to w = 512, 1 at w = 1024 (a lane's 164 KB of
# shared memory); past 1024 the lane's state is in a device scratch.  The
# cases: several lanes per block whose step counts differ by tens of
# times (w = 32, 64, 512), B not a multiple of 4 (5, 6, 7), k < w padding
# and an empty last lane (all), w = 1024 in shared memory, and a short
# t_store that forces the relaunch (w = 8 and 256)
@pytest.mark.parametrize("B,w,density,t_store", [
    (3, 1, 1.0, None), (4, 2, 0.7, None), (5, 8, 0.5, 3), (6, 64, 0.2, None),
    (8, 32, 0.4, None), (3, 256, 0.02, 40), (2, 512, 0.003, None),
    (7, 512, 0.003, None), (2, 1024, 0.001, 16)])
def test_bna_decompose_kernel_equals_plain(B, w, density, t_store):
    dev = _card()
    d, ks, T_cap = _random_bucket(np.random.default_rng(w), B, w, density)
    want = bna_decompose_ref(d, ks, T_cap)
    before = bna_decompose.launches
    got = bna_decompose(d.to(dev), ks.to(dev), T_cap, t_store=t_store)
    torch.cuda.synchronize()
    assert bna_decompose.launches > before
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)


def _merge_edges(E, m, kind):
    """(events, t0, t1, s, r) int64: random activations over 10^6 time
    units (10^7 for "long", K ~ 1.2e5 at E = 60,000); one interval ("k1");
    K = 33, one row past a tile; every endpoint in one 32-row tile of
    K = 9999 ("hot") or in four adjacent tiles of K = 99,999, some 25,000
    records a tile ("hot_stretches"); or half the edges spanning all of K
    ("span")."""
    rng = np.random.default_rng(E)
    events = None
    if kind == "k1":
        t0, t1 = np.zeros(E, np.int64), np.full(E, 5)
    elif kind == "past_a_tile":
        events = np.arange(34) * 3
        i0 = rng.integers(0, 33, E)
        t0, t1 = events[i0], events[np.minimum(33, i0 + rng.integers(1, 4, E))]
    elif kind == "hot":
        events = np.arange(10_000) * 7
        t0 = events[3200 + rng.integers(0, 16, E)]
        t1 = events[3216 + rng.integers(0, 16, E)]
    elif kind == "hot_stretches":     # four adjacent hot tiles
        events = np.arange(100_000) * 7
        t0 = events[3200 + rng.integers(0, 64, E)]
        t1 = events[3264 + rng.integers(0, 64, E)]
    else:
        span = 10**7 if kind == "long" else 10**6
        t0 = rng.integers(0, span, E)
        t1 = t0 + rng.integers(1, 5000, E)
        if kind == "span":
            t0[::2], t1[::2] = t0.min(), t1.max()
    if events is None:
        events = np.unique(np.concatenate([t0, t1]))
    return [torch.as_tensor(a, dtype=torch.int64) for a in (
        events, t0, t1, rng.integers(0, m, E), rng.integers(0, m, E))]


@pytest.mark.parametrize("E,m,kind", [
    pytest.param(E, m, "random", id=f"{E}-{m}")
    for E, m in [(1, 2), (400, 7), (20_000, 150), (3, 1000),
                 (20_000, 1000)]] + [
    pytest.param(300, 150, "k1", id="K_1"),
    pytest.param(500, 150, "past_a_tile", id="K_33"),
    pytest.param(60_000, 150, "long", id="K_119k"),
    pytest.param(60_000, 1000, "long", id="K_119k-m_1000"),
    pytest.param(50_000, 150, "hot", id="hot_tile"),
    pytest.param(5_000, 1000, "hot", id="hot_tile-m_1000"),
    pytest.param(50_000, 150, "hot_stretches", id="hot_tile-stretches"),
    pytest.param(20_000, 150, "span", id="span_all_of_K"),
    pytest.param(20_000, 150, "repeat", id="repeat_100")])
def test_merge_fix_kernel_equals_plain(E, m, kind):
    """Binning, the chunks' counting sort and the tile scan on the radix-8
    carry; repeated on one stream, a stale completion count or ticket
    (cleared by the binning launch) would show."""
    dev = _card()
    args = _merge_edges(E, m, kind)
    want = merge_fix_ref(*args, m)
    reps = 100 if kind == "repeat" else 1
    dargs = [a.to(dev) for a in args]
    before = merge_fix.launches
    got = [merge_fix(*dargs, m) for _ in range(reps)]
    torch.cuda.synchronize()
    assert merge_fix.launches == before + reps
    for g in got:
        for x, y in zip(g, want):
            assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("w,lanes", [
    (1024, [(1024, 3), (700, 2), (0, 0)]),
    (2048, [(1100, 3), (2048, 1), (1500, 2), (0, 0)])])
def test_bna_decompose_wide_kernel_equals_plain(w, lanes):
    """w = 1024 (one lane a block, all in shared memory) and w = 2048 (the
    layout past 1024 senders: a lane's state in a device scratch), with
    repairs, k < w padding, an empty lane and a relaunch."""
    dev = _card()
    d, ks, T_cap = tight_bucket(np.random.default_rng(w), w, lanes)
    want = bna_decompose_ref(d, ks, T_cap)
    before = bna_decompose.launches
    got = bna_decompose(d.to(dev), ks.to(dev), T_cap, t_store=2)
    torch.cuda.synchronize()
    assert bna_decompose.launches == before + 2
    for x, y in zip(got, want):
        assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("plan_backend", ["pipeline", "python"])
def test_wide_switch_plan_on_card_equals_cpu(plan_backend):
    """A switch of m = 1000 ports, past the 908 whose 32 x 2m scan tile
    once overflowed a block's shared memory: gdm plans on the card through
    either path, launching that path's kernels, equal to the CPU's plan."""
    _card()
    inst = paper_workload(m=1000, mu_bar=2, seed=0, scale=0.01)
    clear_caches()
    bna_step.launches = coflow_merge.launches = 0
    bna_decompose.launches = merge_fix.launches = 0
    got = plan(inst, "gdm", device="cuda", plan_backend=plan_backend, seed=0)
    if plan_backend == "pipeline":
        assert bna_decompose.launches > 0 and merge_fix.launches > 0
    else:
        assert bna_step.launches > 0 and coflow_merge.launches > 0
    clear_caches()
    want = plan(inst, "gdm", device="cpu", plan_backend=plan_backend,
                seed=0)
    verify_transcript(inst, got.transcript())
    _assert_plans_equal(got, want)


# ssd_scan (K5): (B, S, H, G, N, P) and chunk.  The reference sweep's shapes,
# mamba2-2.7b's (H=80, G=1, N=128, P=64, L=128), jamba's G=8, the largest
# tile the kernels take (L = N = P = 128, over several chunks), S = 1, S off
# the chunk, and N, P off the tensor-core tiles (N = 24 and P = 40 padded to
# 32 and 40; N = 20, P = 12, which the bf16 path stages element by
# element).  Tolerances relative to the largest |y|: 1e-4 in float32 (the
# reference's test), 8e-3 in bfloat16 (both round a float32 result to
# bfloat16: two ulps at the top of the range)
_SSD_SHAPES = [((1, 16, 2, 1, 8, 16), 8), ((2, 33, 4, 2, 16, 32), 16),
               ((1, 64, 2, 2, 32, 64), 32), ((1, 40, 8, 1, 16, 8), 64),
               ((2, 1, 80, 1, 128, 64), 128), ((2, 127, 80, 1, 128, 64), 128),
               ((2, 128, 80, 1, 128, 64), 128),
               ((1, 4096, 80, 1, 128, 64), 128),
               ((1, 300, 16, 8, 128, 64), 128),
               ((1, 200, 2, 1, 128, 128), 128),
               ((1, 1, 4, 1, 16, 16), 128), ((1, 77, 4, 2, 24, 40), 32),
               ((1, 96, 2, 1, 20, 12), 32), ((2, 520, 4, 1, 128, 128), 128),
               ((1, 130, 8, 8, 64, 32), 64)]


def _ssd_inputs(shape, dtype, dev, seed=0):
    B, S, H, G, N, P = shape
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(B, S, H, P)), dtype=dtype,
                        device=dev)
    a = torch.as_tensor(rng.uniform(0.55, 1.0, size=(B, S, H)),
                        dtype=torch.float32, device=dev)
    b = torch.as_tensor(rng.normal(size=(B, S, G, N)) * 0.3, dtype=dtype,
                        device=dev)
    c = torch.as_tensor(rng.normal(size=(B, S, G, N)) * 0.3, dtype=dtype,
                        device=dev)
    return x, a, b, c


def _ssd_rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / (want.float().abs().max() + 1e-9))


@pytest.mark.parametrize("shape,chunk", _SSD_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 8e-3)])
def test_ssd_scan_kernel_equals_plain(shape, chunk, dtype, tol):
    dev = _card()
    x, a, b, c = _ssd_inputs(shape, dtype, dev, seed=sum(shape))
    before = ssd_scan.launches
    got = ssd_scan(x, a, b, c, chunk=chunk)
    want = ssd_ref(x, a, b, c)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert bool(torch.isfinite(got).all())
    assert _ssd_rel(got, want) < tol


def test_ssd_scan_kernel_reads_strided_views():
    """b and c split out of one (B, S, C) projection, as models.ssm passes
    them, and x seen through a permute: no copy needed."""
    dev = _card()
    B, S, H, G, N, P = 2, 96, 8, 2, 16, 32
    rng = np.random.default_rng(11)
    xbc = torch.as_tensor(rng.normal(size=(B, S, 2 * G * N + 7)) * 0.3,
                          dtype=torch.float32, device=dev)
    b = xbc[..., :G * N].reshape(B, S, G, N)
    c = xbc[..., G * N:2 * G * N].reshape(B, S, G, N)
    x = torch.as_tensor(rng.normal(size=(B, H, S, P)), dtype=torch.float32,
                        device=dev).permute(0, 2, 1, 3)
    a = torch.as_tensor(rng.uniform(0.55, 1.0, size=(B, S, H)),
                        dtype=torch.float32, device=dev)
    assert not (b.is_contiguous() or x.is_contiguous())
    got = ssd_scan(x, a, b, c, chunk=32)
    want = ssd_ref(x.contiguous(), a, b.contiguous(), c.contiguous())
    torch.cuda.synchronize()
    assert _ssd_rel(got, want) < 1e-4


def test_ssd_scan_bf16_kernel_reads_strided_views():
    """The bf16 (tensor-core) path on views split out of one projection,
    as models.ssm passes them (rows 16-byte aligned: cp.async), and on the
    same views one element into their storage (element by element)."""
    dev = _card()
    B, S, H, G, N, P = 2, 300, 8, 2, 64, 32
    rng = np.random.default_rng(12)
    for misalign in (0, 1):
        flat = torch.as_tensor(
            rng.normal(size=B * S * (H * P + 2 * G * N) + misalign) * 0.3,
            dtype=torch.bfloat16, device=dev)
        xbc = flat[misalign:].view(B, S, H * P + 2 * G * N)
        x, b, c = torch.split(xbc, [H * P, G * N, G * N], dim=-1)
        x = x.reshape(B, S, H, P)
        b = b.reshape(B, S, G, N)
        c = c.reshape(B, S, G, N)
        a = torch.as_tensor(rng.uniform(0.55, 1.0, size=(B, S, H)),
                            dtype=torch.float32, device=dev)
        got = ssd_scan(x, a, b, c, chunk=128)
        want = ssd_ref(x.contiguous(), a, b.contiguous(), c.contiguous())
        torch.cuda.synchronize()
        assert _ssd_rel(got, want) < 8e-3, misalign


def test_ssd_scan_both_paths_on_one_input():
    """The float32 (FMA) and bfloat16 (tensor-core) paths on the same
    values at mamba2-2.7b's head shape over four chunks: each within its own
    tolerance of the plain version in its type."""
    dev = _card()
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 8e-3)):
        x, a, b, c = _ssd_inputs((1, 512, 4, 1, 128, 64), dtype, dev, seed=9)
        got = ssd_scan(x, a, b, c, chunk=128)
        want = ssd_ref(x, a, b, c)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        assert _ssd_rel(got, want) < tol


def test_ssd_scan_kernel_refuses_what_it_does_not_take():
    dev = _card()
    before = ssd_scan.launches
    x, a, b, c = _ssd_inputs((1, 300, 2, 1, 16, 16), torch.float32, dev)
    with pytest.raises(ValueError, match="1..128"):
        ssd_scan(x, a, b, c, chunk=256)
    x, a, b, c = _ssd_inputs((1, 16, 2, 1, 160, 16), torch.float32, dev)
    with pytest.raises(ValueError, match="1..128"):
        ssd_scan(x, a, b, c, chunk=16)
    x, a, b, c = _ssd_inputs((1, 16, 2, 1, 16, 192), torch.float32, dev)
    with pytest.raises(ValueError, match="1..128"):
        ssd_scan(x, a, b, c, chunk=16)
    x, a, b, c = _ssd_inputs((1, 16, 2, 1, 16, 16), torch.float16, dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ssd_scan(x, a, b, c, chunk=16)
    x, a, b, c = _ssd_inputs((1, 16, 2, 1, 16, 16), torch.float32, dev)
    with pytest.raises(TypeError, match="b is"):
        ssd_scan(x, a, b.bfloat16(), c, chunk=16)
    c_strided = c.repeat_interleave(2, dim=3)[..., ::2]
    assert c_strided.shape == c.shape and c_strided.stride(3) == 2
    with pytest.raises(ValueError, match="last dim must be contiguous"):
        ssd_scan(x, a, b, c_strided, chunk=16)
    assert ssd_scan.launches == before


def test_smoke_mamba2_forward_and_serve_on_card_equal_cpu():
    """mamba2-2.7b's f32 smoke config: lm_forward on the card launches K5
    once per layer and equals the CPU within 1e-4; prefill (the chunked
    form) and a fifo serve run with a 16-token (= H) prompt give the same
    logits and tokens on both devices."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm, lm_forward, prefill
    from repro_torch.models.lm import tree_map
    from repro_torch.serve import Request, ServeConfig, ServingEngine

    dev = _card()
    cfg = get_config("mamba2-2.7b").smoke()
    cpu = init_lm(cfg, torch.Generator().manual_seed(0))
    card = tree_map(lambda x: x.to(dev), cpu)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, 40)))
    before = ssd_scan.launches
    lg, _ = lm_forward(cfg, card, toks.to(dev))
    assert ssd_scan.launches == before + cfg.n_layers
    lg_c, _ = lm_forward(cfg, cpu, toks)
    assert float((lg.cpu() - lg_c).abs().max()) < 1e-4
    before = ssd_scan.launches
    plg, cache = prefill(cfg, card, toks.to(dev))
    assert ssd_scan.launches == before        # prefill: the chunked form
    plg_c, cache_c = prefill(cfg, cpu, toks)
    assert float((plg.cpu() - plg_c).abs().max()) < 1e-4
    for name in cache_c["layers"]:
        for key in ("h", "conv"):
            assert float((cache["layers"][name][key].cpu()
                          - cache_c["layers"][name][key]).abs().max()) < 1e-4

    def reqs():
        rng = np.random.default_rng(1)
        return [Request(rid=i, tokens=rng.integers(1, cfg.vocab, size=size),
                        max_new=5, arrival=float(i // 2))
                for i, size in enumerate((6, 16, 9, 16, 3))]

    outs = []
    for params in (card, cpu):
        rs = reqs()
        stats = ServingEngine(cfg, params, ServeConfig(
            slots=2, capacity=32, admission="fifo")).run(rs)
        outs.append((stats, [r.out for r in rs]))
    assert outs[0] == outs[1]
    assert outs[0][0]["completed"] == 5


@pytest.mark.parametrize("arch", ["granite-moe-3b", "qwen3-moe-235b",
                                  "jamba-1.5-large"])
def test_smoke_moe_forward_loss_and_serve_on_card_equal_cpu(arch):
    """The MoE stacks' f32 smoke configs: lm_forward on the card launches
    K4 once per attention layer (and K5 once per mamba layer) and equals
    the CPU's logits and auxiliary loss within 1e-4, every layer's routing
    equal; lm_loss within 1e-5; a fifo serve gives the same tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm, lm_forward, lm_loss, moe
    from repro_torch.models.lm import tree_map
    from repro_torch.serve import Request, ServeConfig, ServingEngine

    dev = _card()
    cfg = get_config(arch).smoke()
    cpu = init_lm(cfg, torch.Generator().manual_seed(0))
    card = tree_map(lambda x: x.to(dev), cpu)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, 40)))
    routes = []
    orig = moe.moe_route

    def noting(cfg_, router, xt):
        r = orig(cfg_, router, xt)
        routes.append((r["idx"].cpu(), r["keep"].cpu()))
        return r

    n_attn = sum(s.kind == "attn" for s in cfg.period) * cfg.n_periods
    n_mamba = cfg.n_layers - n_attn
    moe.moe_route = noting
    try:
        before = (flash_attention.launches, ssd_scan.launches)
        lg, aux = lm_forward(cfg, card, toks.to(dev))
        assert (flash_attention.launches, ssd_scan.launches) == \
            (before[0] + n_attn, before[1] + n_mamba)
        card_routes, routes[:] = list(routes), []
        lg_c, aux_c = lm_forward(cfg, cpu, toks)
    finally:
        moe.moe_route = orig
    assert len(card_routes) == len(routes) > 0
    for (i1, k1), (i2, k2) in zip(card_routes, routes):
        assert torch.equal(i1, i2) and torch.equal(k1, k2)
    assert float((lg.cpu() - lg_c).abs().max()) < 1e-4
    assert abs(float(aux) - float(aux_c)) < 1e-4
    labels = toks.roll(-1, dims=1)
    labels[:, -1] = -1
    assert abs(float(lm_loss(cfg, card, toks.to(dev), labels.to(dev),
                             loss_chunk=16))
               - float(lm_loss(cfg, cpu, toks, labels, loss_chunk=16))) \
        < 1e-5

    def reqs():
        rng = np.random.default_rng(1)
        return [Request(rid=i, tokens=rng.integers(1, cfg.vocab, size=6 + i),
                        max_new=5, arrival=float(i // 2)) for i in range(5)]

    outs = []
    for params in (card, cpu):
        rs = reqs()
        stats = ServingEngine(cfg, params, ServeConfig(
            slots=2, capacity=32, admission="fifo")).run(rs)
        outs.append((stats, [r.out for r in rs]))
    assert outs[0] == outs[1]
    assert outs[0][0]["completed"] == 5


def test_smoke_encdec_on_card_equals_cpu():
    """whisper-large-v3's f32 smoke config: encdec_forward launches K4 for
    every encoder layer and twice a decoder layer (self, cross) and equals
    the CPU within 1e-4; encdec_loss within 1e-5; prefill and 4 decode
    steps within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import (encdec_decode_step, encdec_forward,
                                    encdec_loss, encdec_prefill, init_encdec)
    from repro_torch.models.lm import tree_map

    dev = _card()
    cfg = get_config("whisper-large-v3").smoke()
    cpu = init_encdec(cfg, torch.Generator().manual_seed(0))
    card = tree_map(lambda x: x.to(dev), cpu)
    rng = np.random.default_rng(0)
    frames = torch.as_tensor(rng.normal(
        size=(2, cfg.encoder_seq, cfg.d_model)), dtype=torch.float32)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, 12)))
    before = flash_attention.launches
    lg = encdec_forward(cfg, card, frames.to(dev), toks.to(dev))
    assert flash_attention.launches == \
        before + cfg.n_encoder_layers + 2 * cfg.n_periods
    lg_c = encdec_forward(cfg, cpu, frames, toks)
    assert float((lg.cpu() - lg_c).abs().max()) < 1e-4
    assert abs(float(encdec_loss(cfg, card, frames.to(dev), toks.to(dev),
                                 toks.to(dev)))
               - float(encdec_loss(cfg, cpu, frames, toks, toks))) < 1e-5
    out = []
    for params, d in ((card, dev), (cpu, torch.device("cpu"))):
        p_lg, cache = encdec_prefill(cfg, params, frames.to(d),
                                     toks[:, :8].to(d), capacity=12)
        seq = [p_lg.cpu()]
        for t in range(8, 12):
            p_lg, cache = encdec_decode_step(cfg, params, cache,
                                             toks[:, t:t + 1].to(d))
            seq.append(p_lg.cpu())
        out.append(torch.stack(seq))
    assert float((out[0] - out[1]).abs().max()) < 1e-4


def test_smoke_vlm_on_card_equals_cpu():
    """llava-next-mistral-7b's f32 smoke config: vlm_prefill launches K4
    once per layer, its logits and cache equal the CPU's within 1e-4, and
    vlm_loss within 1e-5."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_vlm, vlm_loss, vlm_prefill
    from repro_torch.models.lm import tree_map

    dev = _card()
    cfg = get_config("llava-next-mistral-7b").smoke()
    cpu = init_vlm(cfg, torch.Generator().manual_seed(0))
    card = tree_map(lambda x: x.to(dev), cpu)
    rng = np.random.default_rng(0)
    patches = torch.as_tensor(rng.normal(
        size=(2, cfg.n_image_tokens, cfg.d_model)), dtype=torch.float32)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, 16)))
    before = flash_attention.launches
    lg, cache = vlm_prefill(cfg, card, patches.to(dev), toks.to(dev))
    assert flash_attention.launches == before + cfg.n_layers
    lg_c, cache_c = vlm_prefill(cfg, cpu, patches, toks)
    assert cache["length"] == cache_c["length"] == cfg.n_image_tokens + 16
    assert float((lg.cpu() - lg_c).abs().max()) < 1e-4
    for name in cache_c["layers"]:
        for kv in ("k", "v"):
            assert float((cache["layers"][name][kv].cpu()
                          - cache_c["layers"][name][kv]).abs().max()) < 1e-4
    assert abs(float(vlm_loss(cfg, card, patches.to(dev), toks.to(dev),
                              toks.to(dev)))
               - float(vlm_loss(cfg, cpu, patches, toks, toks))) < 1e-5


# --------------------------------------------------------------------------
# backfilling: the *_bf schedulers and merge_and_fix's fix-up on the card
# --------------------------------------------------------------------------

def _assert_bf_equal(got, want):
    _assert_plans_equal(got, want)
    assert got.schedule.coflow_completions == want.schedule.coflow_completions
    assert got.makespan == want.makespan


@pytest.mark.parametrize("plan_backend", ["pipeline", "python"])
@pytest.mark.parametrize("sched,exec_", [("gdm_bf", "packet"),
                                         ("gdm_rt_bf", "packet"),
                                         ("om_alg_bf", "packet"),
                                         ("gdm_bf", "ledger")])
def test_bf_plan_on_card_equals_cpu(sched, exec_, plan_backend):
    """The *_bf plans on the card equal the same plans on the CPU; the
    fix-up BNA of every merged interval with alpha > 1 runs as a batch on
    the card (bna_decompose on the pipeline, bna_step on the python path)
    and never as the scalar host bna."""
    _card()
    inst = paper_workload(m=20, mu_bar=3, seed=0, scale=0.05,
                          rooted=(sched == "gdm_rt_bf"))
    clear_caches()
    bna_step.launches = bna_decompose.launches = 0
    got = plan(inst, sched, device="cuda", plan_backend=plan_backend,
               seed=0, exec=exec_)
    stats = cache_stats()
    fix = stats["plan"]["fixup"]
    assert fix["scalar_bna"] == 0
    if exec_ == "packet" and sched != "om_alg_bf":   # om_alg: alpha 1
        assert fix["lanes"] > 0
    if plan_backend == "pipeline":
        assert bna_step.launches == 0 and stats["bna"]["repairs"] == 0
        assert fix["launches"] == fix["buckets"] > 0 or not fix["lanes"]
    else:
        assert bna_step.launches > 0 and fix["launches"] == 0
    verify_transcript(inst, got.transcript(), check_capacity=True,
                      makespan=got.makespan)
    clear_caches()
    want = plan(inst, sched, device="cpu", plan_backend=plan_backend, seed=0,
                exec=exec_)
    _assert_bf_equal(got, want)


@pytest.mark.parametrize("plan_backend", ["pipeline", "python"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_and_fix_fixup_on_card_equals_scalar_bna(seed, plan_backend):
    """merge_and_fix(decompose=True) on random merges, on the card: the
    batched fix-up equals the per-interval scalar bna loop."""
    from repro_torch.core import timeline

    _card()
    rng = np.random.default_rng(seed)
    m = int(rng.integers(3, 40))
    units = []
    for uid in range(6):
        E = int(rng.integers(1, 40))
        t0 = rng.integers(0, 200, E).astype(np.int64)
        t1 = t0 + rng.integers(1, 40, E)
        units.append(timeline.UnitSchedule(uid, timeline.EdgeIntervals(
            t0, t1, rng.integers(0, m, E), rng.integers(0, m, E),
            np.full(E, uid), np.full(E, uid), rng.integers(0, 3, E)), []))
    clear_caches()
    bna_decompose.launches = 0
    got = timeline.merge_and_fix(units, m, decompose=True, device="cuda",
                                 plan_backend=plan_backend)
    fix = cache_stats()["plan"]["fixup"]
    assert fix["lanes"] > 0 and fix["scalar_bna"] == 0
    assert (bna_decompose.launches > 0) == (plan_backend == "pipeline")
    want = timeline._decompose(np.asarray(got.events), got.merged,
                               got.alphas, got.exp, m, device=None)
    assert got.exact_completion == want[1]
    assert len(got.decomposition) == len(want[0])
    for a, b in zip(got.decomposition, want[0]):
        assert (a.t0, a.dur) == (b.t0, b.dur)
        assert np.array_equal(a.srcs, b.srcs)
        assert np.array_equal(a.dsts, b.dsts)
    for name in ("t0", "t1", "s", "r", "owner", "jid", "cid"):
        assert np.array_equal(getattr(got.coflow_edges, name),
                              getattr(want[2], name))


def test_fixup_overflow_interval_on_card_takes_the_int64_step():
    """An interval demand whose loads pass int32 leaves bna_decompose for
    the batched path: bna_step's int64 instance on the card."""
    import warnings

    from repro_torch.core import fixup_pieces

    _card()
    L = 2**31 - 9
    sub = np.array([[L, L], [L, 0]], np.int64)
    clear_caches()
    bna_step.launches = bna_decompose.launches = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        (got,) = fixup_pieces([sub], "pipeline", "cuda")
    fix = cache_stats()["plan"]["fixup"]
    assert fix["bucket_fallbacks"] == 1 and bna_decompose.launches == 0
    assert bna_step.launches > 0
    want = bna(sub)
    assert [(t, p.tolist()) for t, p in got] == \
        [(t, p.tolist()) for t, p in want]


def test_fixup_bucket_past_the_budget_splits_on_card(monkeypatch):
    """A bucket over the launch budget goes down in chunks, one
    bna_decompose launch each, with the pieces of one launch."""
    from repro_torch.core import pipeline

    _card()
    rng = np.random.default_rng(3)
    subs = []
    for _ in range(9):
        k = int(rng.integers(5, 9))
        x = rng.integers(0, 30, (k, k))
        x[:, 0] += 1
        x[0, :] += 1
        subs.append(x.astype(np.int64))
    clear_caches()
    bna_decompose.launches = 0
    whole = pipeline.decompose_pieces(subs, device="cuda")
    assert bna_decompose.launches == 1
    lane = 4 * (2 * 8 * 8 + (8 * 8 + 16) * 9)
    monkeypatch.setattr(pipeline, "LAUNCH_BUDGET_BYTES", 3 * lane)
    split = pipeline.decompose_pieces(subs, device="cuda")
    assert bna_decompose.launches >= 4
    cpu = pipeline.decompose_pieces(subs, device="cpu")
    for g, w, c in zip(split, whole, cpu):
        for x in (g, w):
            assert [(t, p.tolist()) for t, p in x] == \
                [(t, p.tolist()) for t, p in c]


# --------------------------------------------------------------------------
# the online scheduler: the session, its drivers and coflow admission
# --------------------------------------------------------------------------

def _stream(n=24):
    from repro_torch.core import stream_jobs

    return stream_jobs(8, n, 7, process="mmpp", load=0.9, mu=2)


def _online_equal(got, want):
    assert got.job_completions == want.job_completions
    assert got.twct() == want.twct()
    keys = ("reschedules", "repairs", "full_replans", "groups_reused",
            "groups_replanned", "gamma_rescales")
    assert {k: got.stats["session"][k] for k in keys} == \
        {k: want.stats["session"][k] for k in keys}


@pytest.mark.parametrize("plan_backend", ["pipeline", "python"])
@pytest.mark.parametrize("sched,opts", [
    ("om_alg", {}), ("gdm", {"delays": "spread", "gamma": "pinned"}),
    ("gdm_rt", {"delays": "spread"})])
def test_session_stream_on_card_equals_cpu(sched, opts, plan_backend):
    """A stream through a session on the card equals the same stream on
    the CPU, counters included, and launches the plan backend's kernels."""
    from repro_torch.core import run_stream

    _card()
    jobs = _stream()
    clear_caches()
    for fn in (bna_step, coflow_merge, bna_decompose, merge_fix):
        fn.launches = 0
    got = run_stream(jobs, 8, sched, device="cuda", plan_backend=plan_backend,
                     seed=0, **opts)
    path = (bna_decompose, merge_fix) if plan_backend == "pipeline" \
        else (bna_step, coflow_merge)
    assert all(fn.launches > 0 for fn in path)
    clear_caches()
    want = run_stream(jobs, 8, sched, device="cpu", plan_backend=plan_backend,
                      seed=0, **opts)
    _online_equal(got.online, want.online)


@pytest.mark.parametrize("first,then", [("cuda", "cpu"), ("cpu", "cuda")])
def test_session_snapshot_moves_between_card_and_cpu(first, then):
    """A snapshot taken on one device restores on the other and carries on
    bit-identically (the ledger is host data)."""
    from repro_torch.core import SchedulerSession, run_stream
    from repro_torch.core.stream import StreamDriver

    _card()
    jobs = _stream()
    opts = {"delays": "spread", "seed": 0, "gamma": "pinned"}
    want = run_stream(jobs, 8, "gdm", device=first, **opts)
    drv = StreamDriver(8, "gdm", device=first, **opts)
    for j in jobs[:9]:
        drv.feed(j)
    resumed = SchedulerSession.restore(drv.session.snapshot(), jobs[:9],
                                       "gdm", device=then, **opts)
    assert resumed.device.type == then
    for j in jobs[9:]:
        resumed.submit(j)
    resumed.advance()
    out = resumed.result()
    assert out.job_completions == want.online.job_completions
    assert out.twct() == want.online.twct()


def test_pinned_spread_replans_on_card_hit_group_and_gkey_caches():
    """Spread-mode gdm under a pinned gamma on the card: the replans
    reassemble cached group blocks and extend the cached grouping prefix
    (the LRUs the one-shot plan path leaves idle), and every repaired part
    records the card."""
    from repro_torch.core import SchedulerSession, stream_jobs

    _card()
    jobs = stream_jobs(8, 40, 7, process="poisson", load=0.9, mu=2)
    clear_caches()
    s = SchedulerSession(8, "gdm", device="cuda", delays="spread", seed=0,
                         gamma="pinned")
    for j in jobs:
        s.advance(until=j.release)
        s.submit(j)
        s.frontier()
        plan_ = s.last_plan
        if plan_ is not None and plan_.schedule.meta.get("repaired"):
            assert all(p.device.type == "cuda"
                       for p in plan_.schedule.parts)
    s.advance()
    st = cache_stats()
    assert s.stats.repairs > 0
    assert st["group"]["hits"] > 0 and st["gkey"]["hits"] > 0
    assert st["gkey"]["prefix"]["extended"] + st["gkey"]["prefix"]["exact"] > 0


def test_coflow_admission_serve_on_card_equals_cpu():
    """The serving engine with coflow admission (the default) on the card:
    its session plans on the card, and the run equals the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm
    from repro_torch.models.lm import tree_map
    from repro_torch.serve import Request, ServeConfig, ServingEngine

    dev = _card()
    cfg = get_config("qwen3-1.7b").smoke()
    cpu = init_lm(cfg, torch.Generator().manual_seed(0))
    card = tree_map(lambda x: x.to(dev), cpu)

    def reqs():
        rng = np.random.default_rng(3)
        return [Request(rid=i, tokens=rng.integers(1, cfg.vocab,
                                                   size=int(rng.integers(4, 17))),
                        max_new=5, weight=float(rng.uniform(0.5, 2.0)),
                        arrival=float(i // 2))
                for i in range(7)]

    outs = []
    for params in (card, cpu):
        eng = ServingEngine(cfg, params, ServeConfig(slots=3, capacity=32))
        rs = reqs()
        stats = eng.run(rs)
        outs.append((stats, [r.out for r in rs], [r.finish_step for r in rs]))
        assert eng._session.device.type == params["embed"].device.type
        assert len(eng.admission_plan_s) == 4    # one per arrival tick
    assert outs[0] == outs[1]
    assert outs[0][0]["completed"] == 7


# the zoo (repro_torch.scenarios) at tests/test_scenarios.py's MID sizes
_ZOO_MID = {
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


def _plan_card_and_cpu(inst, sched, plan_backend, **opts):
    """``sched``'s plan of ``inst`` on the card, which must launch the plan
    backend's kernels, and the same plan on the CPU."""
    clear_caches()
    for fn in (bna_step, coflow_merge, bna_decompose, merge_fix):
        fn.launches = 0
    got = plan(inst, sched, device="cuda", plan_backend=plan_backend, seed=0,
               **opts)
    torch.cuda.synchronize()
    path = (bna_decompose, merge_fix) if plan_backend == "pipeline" \
        else (bna_step, coflow_merge)
    assert all(fn.launches > 0 for fn in path)
    clear_caches()
    want = plan(inst, sched, device="cpu", plan_backend=plan_backend, seed=0,
                **opts)
    return got, want


@pytest.mark.parametrize("plan_backend", ["pipeline", "python"])
@pytest.mark.parametrize("sched", ["gdm", "gdm_rt", "om_alg"])
@pytest.mark.parametrize("scen", sorted(_ZOO_MID))
def test_zoo_mid_plan_on_card_equals_cpu(scen, sched, plan_backend):
    """Every scenario of the port's registry at MID size, planned on the
    card through either plan backend, equals the CPU's plan."""
    from repro_torch import scenarios

    _card()
    built = scenarios.build(scen, seed=0, **_ZOO_MID[scen])
    inst = scenarios.strip_releases(built.instance)
    got, want = _plan_card_and_cpu(
        inst, sched, plan_backend,
        **scenarios.scheduler_opts(sched, built.meta))
    verify_transcript(inst, got.transcript())
    _assert_plans_equal(got, want)
    assert got.makespan == want.makespan


@pytest.mark.parametrize("plan_backend", ["pipeline", "python"])
@pytest.mark.parametrize("sched", ["gdm", "gdm_rt", "om_alg"])
def test_gap_instance_plan_on_card_equals_cpu(sched, plan_backend):
    """Lemma 2's gap instance (K = 4: 64 one-flow coflows under a dense
    DAG, every bucket of width 1) on the card equals the CPU's plan, and no
    plan beats the optimum (2K+1)K."""
    from repro_torch.core import gap_instance, gap_optimal_schedule_length

    _card()
    inst = gap_instance(4, d=1)
    opts = {"require_tree": False} if sched == "gdm_rt" else {}
    got, want = _plan_card_and_cpu(inst, sched, plan_backend, **opts)
    _assert_plans_equal(got, want)
    assert got.makespan == want.makespan
    assert got.makespan >= gap_optimal_schedule_length(4, 1)


@pytest.mark.parametrize("plan_backend", ["pipeline", "python"])
def test_fsp_reduction_plan_on_card_equals_cpu(plan_backend):
    """Theorem 1's coflow job of an 8 x 32 flow shop through gdm_rt on the
    card equals the CPU's plan and passes verify_schedule."""
    from repro_torch.core import fsp_to_coflow_job, verify_schedule

    _card()
    p = np.random.default_rng(0).integers(1, 101, size=(8, 32))
    inst = fsp_to_coflow_job(p)
    got, want = _plan_card_and_cpu(inst, "gdm_rt", plan_backend)
    _assert_plans_equal(got, want)
    verify_schedule(inst, got.schedule)


@pytest.mark.parametrize("plan_backend", ["pipeline", "python"])
def test_planner_shared_session_on_card_equals_cpu(plan_backend):
    """The collective planner on an 8 x 8 pod: three phases on one session
    on the card, each phase's order and makespans equal to the CPU's."""
    from repro_torch.dist import planner

    _card()
    outs = []
    for device in ("cuda", "cpu"):
        clear_caches()
        bna_decompose.launches = merge_fix.launches = 0
        bna_step.launches = coflow_merge.launches = 0
        rows, shared = [], None
        for seed in (0, 1, 2):
            step = planner.coflows_from_step(
                planner.synthetic_collective_ops(n_ops=32, seed=seed),
                8, 8, 8)
            res = planner.plan(step, device=device, plan_backend=plan_backend) \
                if shared is None else planner.plan(step, session=shared)
            shared = res.session
            assert sorted(res.order) == list(range(step.n))
            rows.append((res.order, res.planner_makespan, res.naive_makespan))
        assert shared.device.type == device
        if device == "cuda":
            path = (bna_decompose, merge_fix) if plan_backend == "pipeline" \
                else (bna_step, coflow_merge)
            assert all(fn.launches > 0 for fn in path)
        outs.append((rows, shared.result().job_completions))
    assert outs[0] == outs[1]


# --- training on the card ----------------------------------------------------

def _smoke_batch(cfg, B=2, S=24, seed=0):
    from repro_torch.data import DataConfig, SyntheticTokens

    if cfg.family == "vlm":
        S = S - cfg.n_image_tokens
    return SyntheticTokens(cfg, DataConfig(seq_len=S, global_batch=B,
                                           seed=seed)).batch_at(0)


def _grads_on(cfg, params, batch):
    from repro_torch.train.step import _value_and_grad, loss_for

    return _value_and_grad(loss_for(cfg), params, batch)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-1.7b",
                                  "granite-moe-3b", "whisper-large-v3",
                                  "llava-next-mistral-7b", "mamba2-2.7b",
                                  "jamba-1.5-large"])
def test_smoke_loss_gradient_on_card_equals_cpu(arch):
    """loss_for(cfg) and every gradient leaf of a float32 smoke config on
    the card (K4 forward and backward in every attention, K5 forward and
    backward in every mamba layer) against the CPU (autograd through the
    plain attention, the plain scan's backward): loss within 1e-5
    relative, each leaf within 1e-4 of its largest |gradient|.  K4's and
    K5's backward kernels launch once per attention and mamba layer."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import tree_leaves, tree_map
    from repro_torch.train.step import init_params, leaf_paths

    dev = _card()
    cfg = get_config(arch).smoke()
    cpu = init_params(cfg, torch.Generator().manual_seed(0))
    card = tree_map(lambda x: x.to(dev), cpu)
    batch = _smoke_batch(cfg)
    before = (attn_bwd_dq.launches, ssd_bwd_chunk.launches)
    loss, grads = _grads_on(cfg, card, {k: v.to(dev)
                                        for k, v in batch.items()})
    torch.cuda.synchronize()
    kinds = [spec.kind for spec in cfg.period] * cfg.n_periods
    n_attn = (kinds.count("attn") if cfg.family != "encdec"
              else cfg.n_encoder_layers + 2 * cfg.n_layers)
    assert attn_bwd_dq.launches - before[0] == n_attn
    assert ssd_bwd_chunk.launches - before[1] == kinds.count("mamba")
    loss_c, grads_c = _grads_on(cfg, cpu, batch)
    assert abs(float(loss) - float(loss_c)) <= 1e-5 * abs(float(loss_c))
    for path, g, w in zip(leaf_paths(grads), tree_leaves(grads),
                          tree_leaves(grads_c)):
        err = float((g.cpu() - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (path, err)


def test_smoke_attention_projection_gradient_on_card():
    """The fault this slice fixes, at its smallest: a 1-layer smoke
    lm_loss on the card gave wq (the q projection, reached only through
    attention) a zero gradient.  It equals the CPU's now."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import tree_map
    from repro_torch.train.step import init_params

    dev = _card()
    cfg = get_config("qwen3-1.7b").smoke().replace(n_periods=1)
    cpu = init_params(cfg, torch.Generator().manual_seed(0))
    card = tree_map(lambda x: x.to(dev), cpu)
    batch = _smoke_batch(cfg)
    _, g = _grads_on(cfg, card, {k: v.to(dev) for k, v in batch.items()})
    _, w = _grads_on(cfg, cpu, batch)
    gq, wq = g["stack"]["l0"]["attn"]["wq"].cpu(), \
        w["stack"]["l0"]["attn"]["wq"]
    assert float(wq.abs().max()) > 0
    assert float((gq - wq).abs().max()) <= 1e-4 * float(wq.abs().max())


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-1.5-large"])
def test_smoke_ssm_gradient_on_card_takes_no_plain_version(arch,
                                                           monkeypatch):
    """A mamba layer's gradient on the card goes through K5's kernels
    alone: with the plain scans, the plain backward and the chunked form
    made to raise, the smoke gradient still runs, with two K5 forwards per
    mamba layer under remat (the recomputed one) and one of each backward
    wrapper."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan import ref as ssd_refs
    from repro_torch.models import ssm
    from repro_torch.models.lm import tree_map
    from repro_torch.train.step import init_params

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on the card")

    for mod, name in ((ops, "ssd_ref"), (ops, "ssd_bwd_ref"),
                      (ssd_refs, "ssd_bwd_state_ref"),
                      (ssd_refs, "ssd_bwd_chunk_ref"),
                      (ssd_refs, "ssd_ref"), (ssd_refs, "ssd_bwd_ref"),
                      (ssm, "_ssd_chunked")):
        monkeypatch.setattr(mod, name, refuse)
    dev = _card()
    cfg = get_config(arch).smoke()
    card = tree_map(lambda x: x.to(dev),
                    init_params(cfg, torch.Generator().manual_seed(0)))
    batch = {k: v.to(dev) for k, v in _smoke_batch(cfg).items()}
    before = (ssd_scan.launches, ssd_bwd_state.launches,
              ssd_bwd_chunk.launches)
    _grads_on(cfg, card, batch)
    torch.cuda.synchronize()
    n = [spec.kind for spec in cfg.period].count("mamba") * cfg.n_periods
    fwd = n if cfg.remat == "none" else 2 * n
    assert (ssd_scan.launches - before[0], ssd_bwd_state.launches
            - before[1], ssd_bwd_chunk.launches - before[2]) == (fwd, n, n)


def test_smoke_train_step_on_card_equals_cpu():
    """Three build_train_step steps of qwen3-1.7b's float32 smoke config
    from one state on both devices: loss and grad norm within 1e-5
    relative, the parameters within 3 x 2 lr (AdamW moves an element about
    lr sign(g) a step: a near-zero gradient of the other sign moves it
    2 lr), nearly all within 1e-5."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import tree_leaves, tree_map
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import (TrainState, build_train_step,
                                        init_train_state)

    dev = _card()
    cfg = get_config("qwen3-1.7b").smoke()
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    cpu = init_train_state(cfg, torch.Generator().manual_seed(0))
    states = {"cpu": cpu, dev: TrainState(*(
        tree_map(lambda x: x.to(dev), t)
        for t in (cpu.params, cpu.opt, cpu.step)))}
    step = build_train_step(cfg, opt)
    for i in range(3):
        batch = _smoke_batch(cfg, B=4, S=32, seed=i)
        metrics = {}
        for d in ("cpu", dev):
            states[d], metrics[d] = step(states[d], {k: v.to(d) for k, v in
                                                     batch.items()})
        for key in ("loss", "grad_norm"):
            a, b = float(metrics[dev][key]), float(metrics["cpu"][key])
            assert abs(a - b) <= 1e-5 * abs(b), key
    diff = torch.cat([(a.cpu() - b).abs().ravel() for a, b in zip(
        tree_leaves(states[dev].params), tree_leaves(states["cpu"].params))])
    assert float(diff.max()) <= 3 * 2 * opt.lr + 1e-5
    assert float((diff <= 1e-5).float().mean()) >= 0.999


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "jamba-1.5-large"])
def test_crash_resume_on_card_is_bit_exact(tmp_path, arch):
    """The reference's crash/resume protocol on the card (tinyllama's smoke
    config, and jamba's: K4, K5 and the MoE layer in one run): crash at
    step 7, resume from the step-6 checkpoint, run to 12; every parameter
    bit-equal to an uninterrupted run."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.ft import FTConfig, TrainRunner
    from repro_torch.models.lm import tree_leaves
    from repro_torch.train.optim import OptConfig

    dev = _card()
    cfg = get_config(arch).smoke()

    class Boom(Exception):
        pass

    def hook(step):
        if step == 7:
            raise Boom()

    def mk(h=None, d="a"):
        return TrainRunner(cfg, OptConfig(lr=1e-3, warmup_steps=2,
                                          total_steps=50),
                           DataConfig(seq_len=32, global_batch=4, seed=0),
                           FTConfig(ckpt_dir=str(tmp_path / d),
                                    ckpt_every=3),
                           fault_hook=h, device=dev)

    with pytest.raises(Boom):
        mk(hook).run(12)
    r2 = mk()
    resumed = r2.run(12)
    assert r2.metrics_log[0]["step"] == 6
    clean = mk(d="b").run(12)
    for a, b in zip(tree_leaves(resumed.params), tree_leaves(clean.params)):
        assert a.device.type == "cuda" and torch.equal(a, b)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-2.7b"])
def test_mesh_step_on_one_rank_nccl_equals_the_step_without(arch):
    """A training step of the smoke config on a (1, 1) ("data", "model")
    mesh over a real NCCL group of one rank (an in-memory store), the
    state distributed by the rule table, against the same step with no
    mesh from the same seed and batch: the same bits of the loss, the grad
    norm, every updated parameter and both moments, and the kernels
    launched through ``local_map`` as often as without a mesh."""
    from repro_torch.configs import get_config
    from repro_torch.dist.partition import (batch_pspecs, distribute,
                                            distribute_state)
    from repro_torch.launch.mesh import (make_production_mesh, mesh_rules,
                                         one_rank_group)
    from repro_torch.models.lm import tree_leaves
    from repro_torch.models.sharding import mesh_context
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import build_train_step, init_train_state

    dev = _card()
    cfg = get_config(arch).smoke()
    g = torch.Generator(dev).manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 64), generator=g,
                              device=dev, dtype=torch.int32)
             for k in ("tokens", "labels")}
    step = build_train_step(cfg, OptConfig(warmup_steps=1))

    def state():
        return init_train_state(cfg, torch.Generator(dev).manual_seed(0),
                                device=dev)

    kernel = flash_attention if arch == "qwen3-1.7b" else ssd_scan
    before = kernel.launches
    s0, m0 = step(state(), batch)
    plain = kernel.launches - before
    with one_rank_group("nccl"):
        mesh = make_production_mesh(shape=(1, 1), device_type="cuda")
        st = distribute_state(state(), mesh)
        b = distribute(batch, batch_pspecs(batch, mesh), mesh)
        before = kernel.launches
        with mesh_context(mesh, mesh_rules(mesh)):
            s1, m1 = step(st, b)
        torch.cuda.synchronize()
        meshed = kernel.launches - before
        loss = m1["loss"].full_tensor() if hasattr(m1["loss"],
                                                   "full_tensor") \
            else m1["loss"]
        assert torch.equal(loss, m0["loss"])
        assert torch.equal(m1["grad_norm"], m0["grad_norm"])
        for tree in (lambda s: s.params, lambda s: s.opt["m"],
                     lambda s: s.opt["v"]):
            for a, p in zip(tree_leaves(tree(s0)), tree_leaves(tree(s1))):
                assert torch.equal(a, p.full_tensor())
    assert plain > 0 and meshed == plain

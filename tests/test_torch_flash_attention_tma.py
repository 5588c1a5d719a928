"""The host side of the bf16 TMA kernels (src/repro_torch/kernels/tma.py,
used by flash_attention/ops.py and ssd_scan/ops.py): which operands TMA can
read as they lie, the strides their tensor maps get, the staged copy made
of the others, and the wrappers' refusal of CPU tensors.  The kernels themselves run only on a card
(tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (attn_bwd_dkdv, attn_bwd_dq,
                                                 attn_bwd_prep,
                                                 flash_attention_lse)
from repro_torch.kernels.flash_attention.ops import _tma_rows
from repro_torch.kernels.tma import (TMA_ALIGN, tma_describable,
                                     tma_operands, tma_staged, tma_strides)

BF16 = torch.bfloat16


def _bshd(B, S, H, d, dtype=BF16):
    """(B, H, S, d) seen through transpose(1, 2), as the model passes it."""
    return torch.zeros((B, S, H, d), dtype=dtype).transpose(1, 2)


def _offset(shape, by, dtype=BF16):
    """A contiguous (B, H, S, d) view whose base is `by` elements into its
    buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + by, dtype=dtype)[by:].view(shape)


@pytest.mark.parametrize("d", [8, 16, 24, 40, 48, 64, 128])
def test_contiguous_rows_of_whole_16_bytes_are_describable(d):
    assert tma_describable(torch.zeros((2, 3, 5, d), dtype=BF16))


@pytest.mark.parametrize("d", [4, 12, 20, 36, 100])
def test_rows_of_odd_16_byte_units_are_not(d):
    # the seq stride (d bf16 = 2 d bytes) is not a multiple of 16 bytes
    assert not tma_describable(torch.zeros((2, 3, 5, d), dtype=BF16))


@pytest.mark.parametrize("H, d", [(8, 128), (16, 128), (24, 64), (4, 24)])
def test_transposed_training_views_are_describable(H, d):
    assert tma_describable(_bshd(2, 7, H, d))


@pytest.mark.parametrize("by, ok", [(0, True), (1, False), (4, False),
                                    (8, True)])
def test_base_must_be_16_byte_aligned(by, ok):
    assert tma_describable(_offset((1, 2, 9, 64), by)) is ok


def test_padded_head_dim_views():
    # a (..., :d) slice of a wider buffer: the stride is the buffer's row
    assert tma_describable(torch.zeros((1, 2, 9, 72), dtype=BF16)[..., :60])
    assert not tma_describable(
        torch.zeros((1, 2, 9, 68), dtype=BF16)[..., :64])


def test_head_dim_must_be_contiguous_and_steps_positive():
    x = torch.zeros((1, 2, 9, 128), dtype=BF16)
    assert not tma_describable(x[..., ::2])
    # a broadcast (stride 0) dim longer than 1 is not describable; one of
    # length 1 is never stepped along
    assert not tma_describable(x[:, :1].expand(1, 3, 9, 128))
    assert tma_describable(x[:1, :1])


def test_length_one_dims_ignore_their_strides():
    # slicing keeps the parent's strides; on a dim of length 1 they are
    # never used, so an odd one does not matter
    x = torch.zeros((3, 5, 7, 16), dtype=BF16)
    v = x[1:2, 2:3]
    assert tma_describable(v)
    sb, sh, ss = tma_strides(v)
    assert ss == 16
    assert sb % (TMA_ALIGN // 2) == 0 and sh % (TMA_ALIGN // 2) == 0


def test_map_strides_keep_real_strides_and_pack_unit_dims():
    v = _bshd(2, 7, 16, 128)
    assert tma_strides(v) == [7 * 16 * 128, 128, 16 * 128]
    one = torch.zeros((1, 1, 33, 24), dtype=BF16)
    # the extent of the whole tensor (33 * 24), rounded up to 8 elements
    assert tma_strides(one) == [792, 792, 24]
    f32 = torch.zeros((1, 4, 1, 4), dtype=torch.float32)
    assert tma_strides(f32) == [16, 4, 16]


@pytest.mark.parametrize("shape, by", [((2, 3, 9, 64), 1), ((1, 4, 5, 20), 0),
                                       ((2, 2, 3, 12), 3), ((1, 1, 1, 4), 0)])
def test_staged_copy_is_describable_and_equal(shape, by):
    rng = np.random.default_rng(sum(shape))
    src = _offset(shape, by)
    src.copy_(torch.as_tensor(rng.normal(size=shape), dtype=BF16))
    got = tma_staged(src)
    assert got.shape == src.shape and got.dtype == src.dtype
    assert tma_describable(got) and torch.equal(got, src)
    assert got.stride(3) == 1 and got.stride(2) % (TMA_ALIGN // 2) == 0


def test_staged_copy_of_a_transposed_view_is_contiguous_in_bhsd():
    rng = np.random.default_rng(3)
    src = torch.as_tensor(rng.normal(size=(2, 5, 3, 20)),
                          dtype=BF16).transpose(1, 2)
    got = tma_staged(src)
    assert torch.equal(got, src) and got.stride()[:3] == (3 * 5 * 24, 5 * 24,
                                                           24)


def test_operands_are_staged_only_where_needed_and_counted():
    class Wrapper:
        staged = 0

    good = torch.zeros((1, 2, 9, 64), dtype=BF16)
    bad = _offset((1, 2, 9, 64), 1)
    out = tma_operands(Wrapper, good, bad, good, bad)
    assert Wrapper.staged == 2
    assert out[0] is good and out[2] is good
    assert out[1] is not bad and tma_describable(out[1])
    assert torch.equal(out[3], bad)


@pytest.mark.parametrize("Sq, padded", [(4096, False), (128, False),
                                        (129, True), (33, True), (1, True)])
def test_lse_and_d_rows_padded_only_where_sq_is_not_16_bytes(Sq, padded):
    class Wrapper:
        staged = 0

    rng = np.random.default_rng(Sq)
    lse, D = (torch.as_tensor(rng.normal(size=(2, 3, Sq)),
                              dtype=torch.float32) for _ in range(2))
    (l2, d2), ld = _tma_rows(Wrapper, lse, D)
    assert Wrapper.staged == (2 if padded else 0)
    assert ld == -(-Sq // 4) * 4 and ld * 4 % TMA_ALIGN == 0
    for got, want in ((l2, lse), (d2, D)):
        assert torch.equal(got[..., :Sq], want)
        assert got.stride() == (3 * ld, ld, 1)
        assert (got is want) is not padded


@pytest.mark.parametrize("wrapper", [attn_bwd_dkdv, attn_bwd_dq])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_bwd_kernel_wrappers_refuse_cpu_tensors(wrapper, dtype):
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.as_tensor(rng.normal(size=s), dtype=dtype)
                   for s in ((1, 4, 9, 16), (1, 2, 9, 16), (1, 2, 9, 16),
                             (1, 4, 9, 16)))
    out, lse = flash_attention_lse(q.float(), k.float(), v.float())
    D = attn_bwd_prep(out, do.float())
    before = (wrapper.launches, wrapper.staged)
    with pytest.raises(ValueError, match="CUDA"):
        wrapper(q, k, v, do, lse, D, causal=True, scale=0.25)
    assert (wrapper.launches, wrapper.staged) == before

"""Wrappers for the flash_attention kernel (K4) and its backward: checks,
dispatch by device, autograd and the launch counters.

``flash_attention`` takes the reference's layout, q (B, Hq, Sq, d) and
k, v (B, Hkv, Sk, d), and computes what
``repro/kernels/flash_attention/ops.py::flash_attention`` computes: GQA
softmax attention with the causal mask aligned to the end of the keys.  A
CPU tensor takes the plain version (``ref.attention_ref``); a CUDA tensor
launches a kernel in ``csrc/flash_attention.cu`` or raises.  Which kernel
is a fixed rule on the type and the head dim (``forward_kernel``):
bfloat16 at d = 64 or 128, every configuration's, runs ``flash_fwd_wgmma``
(wgmma on TMA tiles); bfloat16 at another d the ``mma.sync`` kernel;
float32 the FMA kernel.  The kernels read q, k and v through their strides
(only the head dim must be contiguous), so a (B, S, H, d) tensor seen
through ``transpose(1, 2)`` needs no copy, and the output takes q's memory
layout; for the wgmma kernel an operand whose base or (batch, head, seq)
stride is not a multiple of 16 bytes goes as a staged copy
(``kernels.tma``), counted on ``flash_attention.staged``.  A query row that
sees no key (causal, Sq > Sk) comes out 0 from the wgmma kernel, with lse
-inf.  The kernels index with 64-bit offsets, so the reference's int32
index-space guard has no counterpart; but the extents (B, Hq, Hkv, Sq, Sk,
d) go to every kernel of this file as C ints, so one past 2^31 - 1 raises
(on every device).

When a gradient is wanted (grad mode on and an input that requires it),
``flash_attention`` is a ``torch.autograd.Function``: the forward also
writes each query row's float32 log-sum-exp (``lse``, (B, Hq, Sq)) and the
backward computes dq, dk and dv, through three hand-written kernels on a
card (``attn_bwd_prep``: D = rowsum(dO o O); ``attn_bwd_dkdv``;
``attn_bwd_dq``, the last two on CUDA tensors only) and through
``ref.attention_bwd_ref`` on the CPU, where the forward keeps no lse.  The
serving path (no gradient) writes no lse.  The gradients come back in the
inputs' types and memory layouts; a masked pair adds nothing, so a query
row that sees no key gets dq 0.

``flash_attention.launches`` counts the forward's kernel launches, and
``attn_bwd_prep.launches``, ``attn_bwd_dkdv.launches`` and
``attn_bwd_dq.launches`` the backward's.

bfloat16 dk/dv and dq (and the wgmma forward) read q, k, v and dout by
TMA, whose tensor maps describe an operand as it lies: a contiguous head
dim, a base and (batch, head, seq) strides that are multiples of 16 bytes
(``kernels.tma``).  An operand that is not (a view offset by an element, a
head dim of odd bytes) goes to its kernel as a staged copy (contiguous,
the head dim's row padded to 16 bytes); so do dk/dv's lse and D where Sq
is not a multiple of 4 (their rows padded to 16 bytes);
``flash_attention.staged``, ``attn_bwd_dkdv.staged`` and
``attn_bwd_dq.staged`` count those copies.  The choice is made from the
layout before the launch, never after a failure.
"""
from __future__ import annotations

import ctypes

import torch

from .. import PLAIN_DEVICES, load_kernel
from ..tma import TMA_ALIGN, tma_operands, tma_staged, tma_strides
from .ref import (attention_bwd_prep_ref, attention_bwd_ref, attention_ref,
                  attention_lse_ref)

__all__ = ["flash_attention", "flash_attention_lse", "flash_attention_bwd",
           "forward_kernel", "FORWARD_KERNELS", "attn_bwd_prep",
           "attn_bwd_dkdv", "attn_bwd_dq", "MAX_HEAD_DIM",
           "MAX_BWD_HEAD_DIM"]

MAX_HEAD_DIM = 256          # the forward kernel's largest head-dim tile
MAX_BWD_HEAD_DIM = 128      # the backward kernels' (every config's d)
_DTYPES = (torch.float32, torch.bfloat16)
# the forward's kernels, by the route code flash_attention_launch takes
FORWARD_KERNELS = ("fma", "mma", "wgmma")
_I32_MAX = 2**31 - 1        # the extents go to the kernels as C ints


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention takes 4-d q, k, v, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    B, Hq, Sq, d = q.shape
    _, Hkv, Sk, _ = k.shape
    if k.shape != (B, Hkv, Sk, d) or v.shape != k.shape:
        raise ValueError(
            f"flash_attention operand shapes disagree: q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if Hkv == 0 or Hq % Hkv != 0:
        raise ValueError(f"GQA requires Hq % Hkv == 0, got {Hq}, {Hkv}")
    for name, a in (("k", k), ("v", v)):
        if a.dtype != q.dtype:
            raise TypeError(f"{name} is {a.dtype} but q is {q.dtype}")
        if a.device != q.device:
            raise ValueError(f"{name} is on {a.device}, q on {q.device}")


def _extents_error(name: str, q: torch.Tensor, k: torch.Tensor) -> str:
    return (f"{name} takes every extent up to 2^31 - 1 (its kernels' int "
            f"arguments), got q {tuple(q.shape)}, k {tuple(k.shape)}")


def _strides(*tensors) -> list[int]:
    return [a.stride(i) for a in tensors for i in range(3)]


def _launch(fn, err_name: str, tensor: torch.Tensor, *args) -> None:
    with torch.cuda.device(tensor.device):
        stream = torch.cuda.current_stream(tensor.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"{err_name} kernel launch failed: CUDA error {err}")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             scale: float, with_lse: bool):
    """(out, lse or None); lse (B, Hq, Sq) float32, -inf on a row that sees
    no key."""
    B, Hq, Sq, d = q.shape
    _, Hkv, Sk, _ = k.shape
    if max(B, Hq, Hkv, Sq, Sk, d) > _I32_MAX:
        raise ValueError(_extents_error("flash_attention", q, k))
    if q.device.type in PLAIN_DEVICES:
        out = attention_ref(q, k, v, causal=causal, scale=scale)
        lse = attention_lse_ref(q, k, causal=causal, scale=scale) \
            if with_lse else None
        return out, lse
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu, meta or cuda, not "
                         f"{q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the flash_attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the flash_attention kernel takes head dim <= "
                         f"{MAX_HEAD_DIM}, got {d}")
    if Sk == 0:
        raise ValueError("flash_attention needs at least one key")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous "
                             f"(stride {a.stride(3)})")
    out = torch.empty_like(q)      # q's layout (a dense view keeps it)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if out.numel() == 0:
        return out, lse
    route = _route(q.dtype, d)
    if FORWARD_KERNELS[route] == "wgmma":
        q, k, v = tma_operands(flash_attention, q, k, v)
        strides = _operand_strides(q, k, v)
    else:
        strides = _strides(q, k, v)
    fn = load_kernel("flash_attention").flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _launch(fn, "flash_attention", q, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None,
            route, B, Hq, Hkv, Sq, Sk, d,
            *strides, *_strides(out), float(scale), int(bool(causal)))
    flash_attention.launches += 1
    return out, lse


def _route(dtype: torch.dtype, d: int) -> int:
    """The route code ``flash_attention_launch`` takes: the index in
    ``FORWARD_KERNELS`` of ``forward_kernel(dtype, d)``."""
    if dtype == torch.bfloat16:
        return 2 if d in (64, 128) else 1
    return 0


def forward_kernel(dtype: torch.dtype, d: int) -> str:
    """The forward kernel a CUDA call of this type and head dim runs:
    ``"wgmma"`` for bfloat16 at d = 64 or 128 (every configuration's head
    dim), ``"mma"`` (``mma.sync``) for bfloat16 at any other d, ``"fma"``
    for float32.  The launch takes it as a route code (``_route``) and
    refuses a route that its d does not fit."""
    return FORWARD_KERNELS[_route(dtype, d)]


class _FlashAttention(torch.autograd.Function):
    """The kernel's forward with lse, and its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        # the CPU's backward (attention_bwd_ref) recomputes what it needs
        out, lse = _forward(q, k, v, causal, scale, q.device.type == "cuda")
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Blocked online-softmax attention; (B, Hq, Sq, d) out, q's type.
    Differentiable in q, k and v."""
    _check(q, k, v)
    if scale is None:
        scale = float(q.shape[3]) ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, bool(causal), float(scale))
    return _forward(q, k, v, bool(causal), float(scale), False)[0]


flash_attention.launches = 0
flash_attention.staged = 0


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, scale: float | None = None):
    """The forward with its row log-sum-exp: (out, lse (B, Hq, Sq) float32),
    lse -inf on a row that sees no key.  Not differentiable."""
    _check(q, k, v)
    if scale is None:
        scale = float(q.shape[3]) ** -0.5
    with torch.no_grad():
        return _forward(q, k, v, bool(causal), float(scale), True)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _bwd_checks(q, k, v, dout, lse) -> None:
    _check(q, k, v)
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout is {tuple(dout.shape)} {dout.dtype}, q "
                         f"{tuple(q.shape)} {q.dtype}")
    if q.device.type != "cuda":
        return
    if q.dtype not in _DTYPES:
        raise TypeError(f"the flash_attention backward kernels take float32 "
                        f"or bfloat16, got {q.dtype}")
    if q.shape[3] > MAX_BWD_HEAD_DIM:
        raise ValueError(f"the flash_attention backward kernels take head "
                         f"dim <= {MAX_BWD_HEAD_DIM}, got {q.shape[3]}")
    for name, a in (("q", q), ("k", k), ("v", v), ("dout", dout)):
        if a.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous "
                             f"(stride {a.stride(3)})")
    B, Hq, Sq, _ = q.shape
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous float32 (B, Hq, Sq)")


def attn_bwd_prep(o: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO o O) in float32, (B, Hq, Sq)."""
    B, Hq, Sq, d = o.shape
    if max(B, Hq, Sq, d) > _I32_MAX:
        raise ValueError(_extents_error("attn_bwd_prep", o, o))
    if o.device.type in PLAIN_DEVICES:
        return attention_bwd_prep_ref(o, dout)
    D = torch.empty((B, Hq, Sq), dtype=torch.float32, device=o.device)
    if D.numel() == 0:
        return D
    fn = load_kernel("flash_attention").attn_bwd_prep_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _launch(fn, "attn_bwd_prep", o, o.data_ptr(), dout.data_ptr(),
            D.data_ptr(), int(o.dtype == torch.bfloat16), B, Hq, Sq, d,
            *_strides(o, dout))
    attn_bwd_prep.launches += 1
    return D


attn_bwd_prep.launches = 0


def _tma_rows(wrapper, *rows) -> tuple[list[torch.Tensor], int]:
    """lse and D, contiguous float32 (B, Hq, Sq), as the bf16 dk/dv kernel
    reads them by TMA: B Hq rows of Sq values whose row stride is a
    multiple of 16 bytes.  Where Sq is not a multiple of 4 (or a base is
    not 16-byte aligned) each goes as a staged copy with padded rows,
    counted on ``wrapper.staged``.  Returns the tensors and their row
    stride in values."""
    Sq = rows[0].shape[2]
    if Sq * rows[0].element_size() % TMA_ALIGN == 0 and all(
            r.data_ptr() % TMA_ALIGN == 0 for r in rows):
        return list(rows), Sq
    out = [tma_staged(r) for r in rows]
    wrapper.staged += len(out)
    return out, out[0].stride(1)


def _operand_strides(*tensors) -> list[int]:
    return [st for t in tensors for st in tma_strides(t)]


def _cuda_only(name: str, q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name} launches a CUDA kernel, got a tensor on "
                         f"{q.device}; flash_attention_bwd takes the plain "
                         f"backward on the CPU")


def attn_bwd_dkdv(q, k, v, dout, lse, D, *, causal: bool, scale: float):
    """(dk, dv) in k's and v's types and layouts, each summed over the kv
    head's query heads.  CUDA tensors only."""
    B, Hq, Sq, d = q.shape
    _, Hkv, Sk, _ = k.shape
    if max(B, Hq, Hkv, Sq, Sk, d) > _I32_MAX:
        raise ValueError(_extents_error("attn_bwd_dkdv", q, k))
    _cuda_only("attn_bwd_dkdv", q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    row_ld = Sq
    if q.dtype == torch.bfloat16:
        q, k, v, dout = tma_operands(attn_bwd_dkdv, q, k, v, dout)
        (lse, D), row_ld = _tma_rows(attn_bwd_dkdv, lse, D)
    fn = load_kernel("flash_attention").attn_bwd_dkdv_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 19
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _launch(fn, "attn_bwd_dkdv", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), D.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), int(q.dtype == torch.bfloat16), B, Hq, Hkv, Sq,
            Sk, d, *_operand_strides(q, k, v, dout), *_strides(dk, dv),
            row_ld, float(scale), int(bool(causal)))
    attn_bwd_dkdv.launches += 1
    return dk, dv


attn_bwd_dkdv.launches = 0
attn_bwd_dkdv.staged = 0


def attn_bwd_dq(q, k, v, dout, lse, D, *, causal: bool, scale: float):
    """dq in q's type and layout; 0 on a row that sees no key.  CUDA
    tensors only."""
    B, Hq, Sq, d = q.shape
    _, Hkv, Sk, _ = k.shape
    if max(B, Hq, Hkv, Sq, Sk, d) > _I32_MAX:
        raise ValueError(_extents_error("attn_bwd_dq", q, k))
    _cuda_only("attn_bwd_dq", q)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    if q.dtype == torch.bfloat16:
        q, k, v, dout = tma_operands(attn_bwd_dq, q, k, v, dout)
    fn = load_kernel("flash_attention").attn_bwd_dq_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 15
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _launch(fn, "attn_bwd_dq", q, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), D.data_ptr(), dq.data_ptr(),
            int(q.dtype == torch.bfloat16), B, Hq, Hkv, Sq, Sk, d,
            *_operand_strides(q, k, v, dout), *_strides(dq), float(scale),
            int(bool(causal)))
    attn_bwd_dq.launches += 1
    return dq


attn_bwd_dq.launches = 0
attn_bwd_dq.staged = 0


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        scale: float | None = None):
    """(dq, dk, dv) of ``flash_attention`` at `dout`, given its output and
    lse: the three backward kernels on a card, ``attention_bwd_ref`` on the
    CPU (which recomputes what it needs from q, k, v, so `out` and `lse`
    may be None there)."""
    if scale is None:
        scale = float(q.shape[3]) ** -0.5
    if dout.stride(3) != 1:
        dout = dout.contiguous()
    _bwd_checks(q, k, v, dout, lse)
    if q.device.type in PLAIN_DEVICES:
        return attention_bwd_ref(q, k, v, dout, causal=causal, scale=scale)
    D = attn_bwd_prep(out, dout)
    dk, dv = attn_bwd_dkdv(q, k, v, dout, lse, D, causal=causal, scale=scale)
    dq = attn_bwd_dq(q, k, v, dout, lse, D, causal=causal, scale=scale)
    return dq, dk, dv

"""Wrapper for the flash_attention kernel (K4): checks, dispatch by device
and the launch counter.

``flash_attention`` takes the reference's layout, q (B, Hq, Sq, d) and
k, v (B, Hkv, Sk, d), and computes what
``repro/kernels/flash_attention/ops.py::flash_attention`` computes: GQA
softmax attention with the causal mask aligned to the end of the keys.  A
CPU tensor takes the plain version (``ref.attention_ref``); a CUDA tensor
launches the kernel in ``csrc/flash_attention.cu`` or raises.  The kernel
reads q, k and v through their strides (only the head dim must be
contiguous), so a (B, S, H, d) tensor seen through ``transpose(1, 2)`` needs
no copy, and the output takes q's memory layout.  It indexes with 64-bit
offsets, so the reference's int32 index-space guard has no counterpart.
``flash_attention.launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .. import load_kernel
from .ref import attention_ref

__all__ = ["flash_attention", "MAX_HEAD_DIM"]

MAX_HEAD_DIM = 256          # the kernel's largest head-dim tile
_DTYPES = (torch.float32, torch.bfloat16)


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """Blocked online-softmax attention; (B, Hq, Sq, d) out, q's type."""
    _check(q, k, v)
    B, Hq, Sq, d = q.shape
    _, Hkv, Sk, _ = k.shape
    if scale is None:
        scale = float(d) ** -0.5
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
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
    if out.numel() == 0:
        return out
    lib = load_kernel("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    strides = [a.stride(i) for a in (q, k, v, out) for i in range(3)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 int(q.dtype == torch.bfloat16), B, Hq, Hkv, Sq, Sk, d,
                 *strides, float(scale), int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

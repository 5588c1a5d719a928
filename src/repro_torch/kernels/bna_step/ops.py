"""Wrapper for the bna_step kernel: int32 staging with the overflow guards,
checks, and dispatch by device.

``stage_int32`` narrows the host int64 state to int32 tensors on the
target device.  It carries the reference's guards
(``repro/kernels/bna_step/ops.py``): every value is bounded by the
effective size D, so the narrowing is exact while max D < 2^31 - 1, and the
stack's element count must stay below 2^31 - 1 too.  Past either it raises.

``bna_step`` runs one step in place.  A CPU tensor takes the plain version
(``ref.bna_step_ref``); a CUDA tensor launches the kernel in
``csrc/bna_step.cu`` or raises.  ``bna_step.launches`` counts the kernel
launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import load_kernel
from .ref import bna_step_ref

__all__ = ["bna_step", "stage_int32"]

_I32_MAX = int(np.iinfo(np.int32).max)


def stage_int32(d: np.ndarray, row: np.ndarray, col: np.ndarray,
                D: np.ndarray, match: np.ndarray,
                device: torch.device) -> tuple[torch.Tensor, ...]:
    """(B, w, w) / (B, w) / (B,) int64 host state -> contiguous int32
    tensors on `device`, guarded as the module docstring says."""
    B, w, _ = d.shape
    if int(D.max(initial=0)) >= _I32_MAX:
        raise ValueError("demand too large for the int32 bna_step kernel "
                         f"(effective size {int(D.max())} >= 2^31-1)")
    if B * w * w >= _I32_MAX:
        raise ValueError("batch too large for the int32 bna_step kernel "
                         f"(element count {B} * {w}^2 >= 2^31-1)")
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
                 .to(device) for a in (d, row, col, D, match))


def _check(d, row, col, D, match) -> None:
    if d.dim() != 3 or d.shape[1] != d.shape[2]:
        raise ValueError(f"d must be (B, w, w), got {tuple(d.shape)}")
    B, w, _ = d.shape
    for name, a, shape in (("row", row, (B, w)), ("col", col, (B, w)),
                           ("D", D, (B,)), ("match", match, (B, w))):
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(a.shape)}")
    for name, a in (("d", d), ("row", row), ("col", col), ("D", D),
                    ("match", match)):
        if a.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {a.dtype}")
        if a.device != d.device:
            raise ValueError(f"{name} is on {a.device}, d on {d.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def bna_step(d: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
             D: torch.Tensor, match: torch.Tensor) -> torch.Tensor:
    """One batched BNA step, in place on d/row/col/D; returns the packed
    (B, 2 + 2w) int32 rows ``[t | D' | piece | invalid]``
    (``ref.unpack_step`` splits them).  Equal to ``ref.bna_step_ref``."""
    _check(d, row, col, D, match)
    if d.device.type == "cpu":
        return bna_step_ref(d, row, col, D, match)
    if d.device.type != "cuda":
        raise ValueError(f"bna_step runs on cpu or cuda, not {d.device}")
    B, w, _ = d.shape
    if w > 1024:
        raise ValueError(f"bna_step kernel takes w <= 1024, got {w}")
    out = torch.empty((B, 2 + 2 * w), dtype=torch.int32, device=d.device)
    lib = load_kernel("bna_step")
    fn = lib.bna_step_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(d.device):
        stream = torch.cuda.current_stream(d.device).cuda_stream
        err = fn(d.data_ptr(), row.data_ptr(), col.data_ptr(), D.data_ptr(),
                 match.data_ptr(), out.data_ptr(), B, w, stream)
    if err != 0:
        raise RuntimeError(f"bna_step kernel launch failed: CUDA error {err}")
    bna_step.launches += 1
    return out


bna_step.launches = 0

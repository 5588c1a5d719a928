"""Wrapper for the bna_step kernel: staging in the narrowest exact type,
checks, and dispatch by device.

``stage_state`` copies the host int64 state to tensors on the target
device.  Every value is bounded by the effective size D, so it stages int32
while max D < 2^31 - 1 (the reference's guard for its int32 kernel,
``repro/kernels/bna_step/ops.py``) and int64 otherwise, where the
reference's numpy step works in int64 too.  The kernel indexes with 64-bit
offsets, so the stack's element count has no limit of its own.

``bna_step`` runs one step in place on int32 or int64 tensors.  A CPU
tensor takes the plain version (``ref.bna_step_ref``); a CUDA tensor
launches the kernel's instance for its type in ``csrc/bna_step.cu`` or
raises.  ``bna_step.launches`` counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import load_kernel
from .ref import bna_step_ref

__all__ = ["bna_step", "stage_state"]

_I32_MAX = int(np.iinfo(np.int32).max)


def stage_state(d: np.ndarray, row: np.ndarray, col: np.ndarray,
                D: np.ndarray, match: np.ndarray,
                device: torch.device) -> tuple[torch.Tensor, ...]:
    """(B, w, w) / (B, w) / (B,) int64 host state -> contiguous tensors on
    `device`: int32 while max D < 2^31 - 1, else int64.  Always copies, so
    the step never writes through to the host arrays."""
    dtype = np.int32 if int(D.max(initial=0)) < _I32_MAX else np.int64
    return tuple(torch.from_numpy(np.array(a, dtype=dtype, order="C"))
                 .to(device) for a in (d, row, col, D, match))


def _check(d, row, col, D, match) -> None:
    if d.dim() != 3 or d.shape[1] != d.shape[2]:
        raise ValueError(f"d must be (B, w, w), got {tuple(d.shape)}")
    B, w, _ = d.shape
    for name, a, shape in (("row", row, (B, w)), ("col", col, (B, w)),
                           ("D", D, (B,)), ("match", match, (B, w))):
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(a.shape)}")
    if d.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"d must be int32 or int64, got {d.dtype}")
    for name, a in (("d", d), ("row", row), ("col", col), ("D", D),
                    ("match", match)):
        if a.dtype != d.dtype:
            raise TypeError(f"{name} is {a.dtype} but d is {d.dtype}: the "
                            "state shares one type, int32 or int64")
        if a.device != d.device:
            raise ValueError(f"{name} is on {a.device}, d on {d.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def bna_step(d: torch.Tensor, row: torch.Tensor, col: torch.Tensor,
             D: torch.Tensor, match: torch.Tensor) -> torch.Tensor:
    """One batched BNA step, in place on d/row/col/D; returns the packed
    (B, 2 + 2w) rows ``[t | D' | piece | invalid]`` in the state's type
    (``ref.unpack_step`` splits them).  Equal to ``ref.bna_step_ref``."""
    _check(d, row, col, D, match)
    if d.device.type == "cpu":
        return bna_step_ref(d, row, col, D, match)
    if d.device.type != "cuda":
        raise ValueError(f"bna_step runs on cpu or cuda, not {d.device}")
    B, w, _ = d.shape
    out = torch.empty((B, 2 + 2 * w), dtype=d.dtype, device=d.device)
    lib = load_kernel("bna_step")
    fn = lib.bna_step_launch if d.dtype == torch.int32 \
        else lib.bna_step_launch_i64
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

"""Wrapper for the merge_fix kernel (K3): checks, the int32 guard, and
dispatch by device.

``merge_fix`` maps the merged edge activations to the per-interval alphas
and expanded durations.  A CPU tensor takes the plain version
(``ref.merge_fix_ref``); a CUDA tensor launches the kernel in
``csrc/merge_fix.cu`` (binning, scatter, scan and duration product, no host
step between) or raises.  ``merge_fix.launches`` counts the kernel
launches.  ``merge_fix_step`` is the host-array entry point that
``core/backend.fused_merge_fix`` calls.

Guard: the per-port counts are int32 and bounded by the number of edge
activations E, so E >= 2^31 - 1 raises (as in
``repro/kernels/merge_fix/ops.py``).  Durations are int64 on every path.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import load_kernel, resolve_device
from .ref import merge_fix_ref

__all__ = ["merge_fix", "merge_fix_step"]

_I32_MAX = 2**31 - 1
_ROWS = 32   # rows per scan block; merge_scan.cuh's kRows


def _check_edge_count(E: int) -> None:
    if E >= _I32_MAX:
        # delta entries and alphas are activation counts bounded by E, and
        # the kernel accumulates them in int32
        raise ValueError("too many edge activations for the int32 "
                         f"merge_fix accumulator ({E} >= 2^31-1)")


def merge_fix(events: torch.Tensor, t0: torch.Tensor, t1: torch.Tensor,
              s: torch.Tensor, r: torch.Tensor,
              m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(events (K+1,), t0, t1, s, r (E,)) int64 -> (alphas (K,), deltas
    (K,)) int64, equal to ``ref.merge_fix_ref``."""
    E = int(t0.numel())
    for name, a in (("events", events), ("t0", t0), ("t1", t1), ("s", s),
                    ("r", r)):
        if a.dim() != 1 or a.dtype != torch.int64:
            raise ValueError(f"{name} must be a 1-D int64 tensor, got "
                             f"{tuple(a.shape)} {a.dtype}")
        if a.device != events.device:
            raise ValueError(f"{name} is on {a.device}, events on "
                             f"{events.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "events" and a.numel() != E:
            raise ValueError(f"{name} has {a.numel()} entries, t0 has {E}")
    _check_edge_count(E)
    if events.device.type == "cpu":
        return merge_fix_ref(events, t0, t1, s, r, m)
    if events.device.type != "cuda":
        raise ValueError(f"merge_fix runs on cpu or cuda, not "
                         f"{events.device}")
    dev = events.device
    K = int(events.numel()) - 1
    alphas = torch.empty(max(K, 0), dtype=torch.int64, device=dev)
    deltas = torch.empty(max(K, 0), dtype=torch.int64, device=dev)
    if K < 1:
        return alphas, deltas
    P = 2 * m
    delta = torch.empty((K + 1) * P, dtype=torch.int32, device=dev)
    totals = torch.empty(((K + _ROWS - 1) // _ROWS) * P, dtype=torch.int32,
                         device=dev)
    fn = load_kernel("merge_fix").merge_fix_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] \
        + [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int] \
        + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(events.data_ptr(), K, t0.data_ptr(), t1.data_ptr(),
                 s.data_ptr(), r.data_ptr(), E, m, delta.data_ptr(),
                 totals.data_ptr(), alphas.data_ptr(), deltas.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"merge_fix kernel launch failed: CUDA error "
                           f"{err}")
    merge_fix.launches += 1
    return alphas, deltas


merge_fix.launches = 0


def merge_fix_step(
    events: np.ndarray,  # (K+1,) sorted unique interval boundaries
    t0: np.ndarray,      # (E,) edge activation start times
    t1: np.ndarray,      # (E,) edge activation end times (exclusive)
    s: np.ndarray,       # (E,) sender port
    r: np.ndarray,       # (E,) receiver port
    m: int,
    *,
    device: "str | torch.device" = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Host arrays in, host int64 (alphas, deltas) out, computed on
    `device` in one round trip: the counterpart of the reference's
    ``merge_fix_step``."""
    dev = resolve_device(device)
    _check_edge_count(int(np.asarray(t0).size))
    args = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(dev)
            for a in (events, t0, t1, s, r)]
    alphas, deltas = merge_fix(*args, m)
    return alphas.cpu().numpy(), deltas.cpu().numpy()

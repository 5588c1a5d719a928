"""Wrappers for the coflow_merge kernel: bin the edge activations, scatter
them into the delta array on the device, and run the kernel.

``coflow_merge`` maps a (K, 2m) int32 delta array to the (K,) int32
alphas.  A CPU tensor takes the plain version (``ref.alphas_ref``); a CUDA
tensor launches the kernel in ``csrc/coflow_merge.cu`` (one pass over the
deltas, after a small kernel clears the carry's counts) or raises.
``coflow_merge.launches`` counts the calls that launch it.  Its scratch
(``scratch``): the carry of merge_scan.cuh, each 32-row tile's column
totals (ceil(K / 32) x 2m int32) and their sums over 8, 64, ... tiles,
with their counts.

Guard: the per-port counts are int32 and bounded by the number of edge
activations E, so E >= 2^31 - 1 raises (as in
``repro/kernels/coflow_merge/ops.py``).  The kernel indexes the delta array
with 64-bit offsets, so a large K * 2m needs no fallback; the port count P
goes to it as a C int, so P past 2^31 - 1 raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import load_kernel, resolve_device
from .ref import alphas_ref, build_delta

__all__ = ["coflow_merge", "interval_alphas", "edge_interval_alphas",
           "carry_words", "scratch"]

_I32_MAX = int(np.iinfo(np.int32).max)
_ROWS = 32   # rows per tile: merge_scan.cuh's kRows


def carry_levels(T: int) -> int:
    """Levels of the scan's carry for T tiles (merge_scan.cuh's Carry):
    level l sums blocks of 8**l tiles, up to the first that covers T."""
    levels, n = 1, 8
    while n < T:
        levels, n = levels + 1, n * 8
    return levels


def carry_words(T: int, P: int) -> int:
    """int32 words of the carry's scratch for T tiles of P ports: each
    level's rows of P values and of one count a port tile (512 ports), and
    the ticket."""
    rows = sum(-(-T // 8 ** lv) for lv in range(carry_levels(T)))
    return rows * (P + -(-P // 512)) + 1


def scratch(K: int, P: int,
            device: "str | torch.device") -> dict[str, torch.Tensor]:
    """The kernel's scratch for a (K, P) delta array, from ``torch.empty``
    (the launch clears what must start at 0)."""
    return {"carry": torch.empty(carry_words(-(-K // _ROWS), P),
                                 dtype=torch.int32, device=device)}


def coflow_merge(delta: torch.Tensor) -> torch.Tensor:
    """(K, P) int32 deltas -> (K,) int32 alphas, equal to
    ``ref.alphas_ref``."""
    if delta.dim() != 2 or delta.dtype != torch.int32:
        raise ValueError(f"delta must be a 2-D int32 tensor, got "
                         f"{tuple(delta.shape)} {delta.dtype}")
    if not delta.is_contiguous():
        raise ValueError("delta must be contiguous")
    K, P = delta.shape
    if P > _I32_MAX:
        # the port count goes to the kernel as a C int
        raise ValueError(f"coflow_merge takes at most 2^31 - 1 ports, got "
                         f"{P}")
    if delta.device.type == "cpu":
        return alphas_ref(delta)
    if delta.device.type != "cuda":
        raise ValueError(f"coflow_merge runs on cpu or cuda, not "
                         f"{delta.device}")
    alphas = torch.empty(K, dtype=torch.int32, device=delta.device)
    if K == 0:
        return alphas
    sc = scratch(K, P, delta.device)
    fn = load_kernel("coflow_merge").coflow_merge_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] \
        + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    with torch.cuda.device(delta.device):
        stream = torch.cuda.current_stream(delta.device).cuda_stream
        err = fn(delta.data_ptr(), K, P, sc["carry"].data_ptr(),
                 alphas.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"coflow_merge kernel failed: CUDA error {err}")
    coflow_merge.launches += 1
    return alphas


coflow_merge.launches = 0


def interval_alphas(
    si: np.ndarray,   # (E,) start interval index per edge activation
    ei: np.ndarray,   # (E,) end interval index (exclusive)
    s: np.ndarray,    # (E,) sender port
    r: np.ndarray,    # (E,) receiver port
    K: int,
    m: int,
    *,
    device: "str | torch.device" = "cuda",
) -> np.ndarray:
    """alpha_t per merged interval (DMA Steps 3-4) as host int64."""
    dev = resolve_device(device)
    if K <= 0:
        return np.zeros(0, dtype=np.int64)
    if int(np.asarray(si).size) >= _I32_MAX:
        raise ValueError(
            f"coflow_merge: {np.asarray(si).size} edge activations overflow "
            "the int32 count accumulators")
    idx = [torch.as_tensor(np.asarray(a, dtype=np.int64)).to(dev)
           for a in (si, ei, s, r)]
    delta = build_delta(*idx, K, m)
    return coflow_merge(delta).cpu().numpy().astype(np.int64)


def edge_interval_alphas(
    events: np.ndarray,  # (K+1,) sorted unique interval boundaries
    t0: np.ndarray,      # (E,) edge activation start times
    t1: np.ndarray,      # (E,) edge activation end times (exclusive)
    s: np.ndarray,
    r: np.ndarray,
    m: int,
    *,
    device: "str | torch.device" = "cuda",
) -> np.ndarray:
    """interval_alphas from raw edge-interval times: the merge_and_fix
    entry point (``core/backend.compute_alphas``).  Bins the activation
    times into interval indices, then runs the kernel."""
    si = np.searchsorted(events, t0)
    ei = np.searchsorted(events, t1)
    return interval_alphas(si, ei, s, r, int(events.size) - 1, m,
                           device=device)

"""Wrapper for the merge_fix kernel (K3): checks, the int32 guard, and
dispatch by device.

``merge_fix`` maps the merged edge activations to the per-interval alphas
and expanded durations.  A CPU tensor takes the plain version
(``ref.merge_fix_ref``); a CUDA tensor launches the kernel in
``csrc/merge_fix.cu`` (three launches: a bucket table of the events'
times, binning and a chunk-local counting sort of the endpoints, then the
tile scan on merge_scan.cuh's radix-8 carry; no host step between) or
raises.  ``merge_fix.launches`` counts
the calls that launch it.  ``merge_fix_step`` is the host-array entry
point that ``core/backend.fused_merge_fix`` calls.

Guard: the per-port counts are int32 and bounded by the number of edge
activations E, so E >= 2^31 - 1 raises (as in
``repro/kernels/merge_fix/ops.py``).  Durations are int64 on every path.
The kernel's endpoint records hold ports below 2^22 and rows below 2^31,
so m >= 2^22 or K >= 2^31 - 1 raises on the card; m and the tiling's
chunk, bin and tile counts go to it as C ints, so any of them outside
[0, 2^31 - 1] raises on every device.

Scratch (``scratch``; no (K + 1) x 2m array): the bucket table (up to
2(K + 1) int32), the endpoints' rows (2E int32) and records (2E int64), each chunk's bin offsets, and the carry:
each 32-row tile's column totals (tiles x 2m int32: ``ref.tile_layout``)
and their sums over 8, 64, ... tiles, with their counts and the ticket.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import load_kernel, resolve_device
from ..coflow_merge.ops import carry_words
from .ref import merge_fix_ref, tile_layout

__all__ = ["merge_fix", "merge_fix_step", "scratch"]

_I32_MAX = 2**31 - 1
_PORT_LIMIT = 2**22   # merge_fix.cu's kPortBits


def _check_edge_count(E: int) -> None:
    if E >= _I32_MAX:
        # delta entries and alphas are activation counts bounded by E, and
        # the kernel accumulates them in int32
        raise ValueError("too many edge activations for the int32 "
                         f"merge_fix accumulator ({E} >= 2^31-1)")


def scratch(K: int, E: int, m: int,
            device: "str | torch.device") -> dict[str, torch.Tensor]:
    """The kernel's scratch for K intervals, E edges and 2m ports, from
    ``torch.empty`` (the first launch clears what must start at 0)."""
    lay = tile_layout(K, E)
    sizes = {"table": lay.nb + 1, "rows": 2 * E,
             "seg": lay.C * (lay.nbins + 1),
             "carry": carry_words(lay.T, 2 * m)}
    buf = torch.empty(sum(sizes.values()), dtype=torch.int32, device=device)
    out = dict(zip(sizes, torch.split(buf, list(sizes.values()))))
    out["recs"] = torch.empty(max(2 * E, 1), dtype=torch.int64, device=device)
    return out


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
    K = int(events.numel()) - 1
    lay = tile_layout(K, E)
    C, nbins, lg = lay.C, lay.nbins, lay.lg
    if not 0 <= m <= _I32_MAX or min(C, nbins, lg) < 0 \
            or max(C, nbins, lg) > _I32_MAX:
        # m and the tiling go to the kernel as C ints
        raise ValueError(f"merge_fix takes m, and tiles K and E into "
                         f"chunks, bins and tiles, in [0, 2^31 - 1]: got "
                         f"m={m}, C={C}, nbins={nbins}, lg={lg}")
    if events.device.type == "cpu":
        return merge_fix_ref(events, t0, t1, s, r, m)
    if events.device.type != "cuda":
        raise ValueError(f"merge_fix runs on cpu or cuda, not "
                         f"{events.device}")
    dev = events.device
    alphas = torch.empty(max(K, 0), dtype=torch.int64, device=dev)
    deltas = torch.empty(max(K, 0), dtype=torch.int64, device=dev)
    if K < 1:
        return alphas, deltas
    if m >= _PORT_LIMIT or K >= _I32_MAX:
        raise ValueError(f"merge_fix on the card takes m < 2^22 and "
                         f"K < 2^31 - 1, got m={m}, K={K}")
    sc = scratch(K, E, m, dev)
    fn = load_kernel("merge_fix").merge_fix_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong] \
        + [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int] \
        + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(events.data_ptr(), K, t0.data_ptr(), t1.data_ptr(),
                 s.data_ptr(), r.data_ptr(), E, m, lay.nb, lay.Ec, C, nbins,
                 lg,
                 *(sc[k].data_ptr() for k in ("table", "rows", "recs", "seg",
                                              "carry")),
                 alphas.data_ptr(), deltas.data_ptr(), stream)
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

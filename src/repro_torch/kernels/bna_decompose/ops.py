"""Wrapper for the bna_decompose kernel: checks and dispatch by device.

``bna_decompose`` decomposes a whole width bucket, step and repair.  A CPU
tensor takes the plain version (``ref.bna_decompose_ref``); a CUDA tensor
launches the kernel in ``csrc/bna_decompose.cu`` or raises.
``bna_decompose.launches`` counts the kernel launches.

The caller guards the int32 range (every row and column load below
2^31 - 1; ``core/pipeline.py`` sends a bucket past it down the batched
path instead).  Storage: the kernel stores the first ``t_store`` steps of
each lane; if a lane took more, the wrapper launches again with room for
all of them, so the result never depends on ``t_store``.  Any width
runs: past 1024 senders a lane's state leaves shared memory for a device
scratch that the wrapper allocates (``layout``).
"""
from __future__ import annotations

import ctypes

import torch

from .. import load_kernel
from .ref import bna_decompose_ref

__all__ = ["bna_decompose", "layout"]

_I32_MAX = 2**31 - 1


def _check(d: torch.Tensor, ks: torch.Tensor, T_cap: int) -> None:
    if d.dim() != 3 or d.shape[1] != d.shape[2]:
        raise ValueError(f"d must be (B, w, w), got {tuple(d.shape)}")
    if tuple(ks.shape) != (d.shape[0],):
        raise ValueError(f"ks must be ({d.shape[0]},), got {tuple(ks.shape)}")
    for name, a in (("d", d), ("ks", ks)):
        if a.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if ks.device != d.device:
        raise ValueError(f"ks is on {ks.device}, d on {d.device}")
    if not 0 <= T_cap < _I32_MAX:
        raise ValueError(f"T_cap must be in [0, 2^31 - 1), got {T_cap}")


def layout(B: int, w: int) -> dict:
    """The kernel's launch layout for a (B, w, w) bucket, as its library
    computes it: lanes (warps) per block, dynamic shared memory per block
    in bytes, and the int32 scratch words per lane of the layout past 1024
    senders (0 at w <= 1024, where a lane's state is in shared memory)."""
    fn = load_kernel("bna_decompose").bna_decompose_layout
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    lanes, smem, words = ctypes.c_int(), ctypes.c_longlong(), \
        ctypes.c_longlong()
    fn(B, w, ctypes.byref(lanes), ctypes.byref(smem), ctypes.byref(words))
    return {"lanes_per_block": lanes.value, "smem_bytes": smem.value,
            "state_words": words.value}


def _launch(d, ks, T_cap: int, T_out: int):
    B, w, _ = d.shape
    dev = d.device
    work = torch.empty_like(d)
    state = torch.empty(B * layout(B, w)["state_words"], dtype=torch.int32,
                        device=dev)
    ts = torch.empty((B, T_out), dtype=torch.int32, device=dev)
    pieces = torch.empty((B, T_out, w), dtype=torch.int32, device=dev)
    D_final = torch.empty(B, dtype=torch.int32, device=dev)
    nsteps = torch.empty(B, dtype=torch.int32, device=dev)
    fn = load_kernel("bna_decompose").bna_decompose_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(d.data_ptr(), ks.data_ptr(), work.data_ptr(),
                 state.data_ptr(), ts.data_ptr(), pieces.data_ptr(),
                 D_final.data_ptr(), nsteps.data_ptr(), B, w, T_cap, T_out,
                 stream)
    if err != 0:
        raise RuntimeError(f"bna_decompose kernel launch failed: CUDA "
                           f"error {err}")
    bna_decompose.launches += 1
    return ts, pieces, D_final, nsteps


def bna_decompose(d: torch.Tensor, ks: torch.Tensor, T_cap: int,
                  t_store: int | None = None):
    """Decompose the bucket ``d (B, w, w)`` (lane b's matrix in its top-left
    ``ks[b] x ks[b]`` block), running each lane until it drains or T_cap
    steps.  Returns ``(ts (B, T), pieces (B, T, w), D_final (B,),
    nsteps (B,))``, int32 on d's device, equal to ``ref.bna_decompose_ref``:
    T is the longest lane's step count, and rows past a lane's own count
    are t = 0, piece = -1.  ``t_store`` (default T_cap) is how many steps
    a lane's first launch stores; it changes memory, not the result."""
    _check(d, ks, T_cap)
    if d.device.type == "cpu":
        return bna_decompose_ref(d, ks, T_cap)
    if d.device.type != "cuda":
        raise ValueError(f"bna_decompose runs on cpu or cuda, not {d.device}")
    T_out = T_cap if t_store is None else max(0, min(int(t_store), T_cap))
    ts, pieces, D_final, nsteps = _launch(d, ks, T_cap, T_out)
    T = int(nsteps.max()) if d.shape[0] else 0
    if T > T_out:   # a lane took more steps than were stored: store all
        ts, pieces, D_final, nsteps = _launch(d, ks, T_cap, T)
    return ts[:, :T], pieces[:, :T], D_final, nsteps


bna_decompose.launches = 0

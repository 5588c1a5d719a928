"""Wrapper for the ssd_scan kernel (K5): checks, chunk padding, dispatch by
device and the launch counter.

``ssd_scan`` computes what ``repro/kernels/ssd_scan/ops.py::ssd_scan``
computes, the Mamba2 SSD scan over x (B, S, H, P), the decay a (B, S, H)
and the state-group inputs b, c (B, S, G, N).  A CPU tensor takes the plain
version (``ref.ssd_ref``, the sequential recurrence); a CUDA tensor
launches the kernels in ``csrc/ssd_scan.cu`` or raises (as it does when a
gradient is wanted: K5 has no backward kernel yet).  Before the launch
it does what the reference's wrapper does: L = min(chunk, S), x, b and c
padded with zeros and a with 1 to a multiple of L (padded steps leave the
state unchanged), loga = log(max(a, 1e-37)) in float32, the output sliced
back to S.  The reference falls back to its oracle past 2^31 - 1 elements
because Pallas indexes in int32; these kernels index with 64-bit
offsets, so that guard has no counterpart here.

The kernels read x, b and c through their (batch, seq, head or group)
strides, so the views that ``models.ssm`` splits out of one projection
need no copy; only the last dim must be contiguous.  They take L, N and P
up to 128 and float32 or bfloat16 inputs (x, b and c of one type).  One
call runs the chunk-parallel scan as ``CUDA_LAUNCHES`` (3) kernels on the
current stream: chunk states, the state pass over the chunks, chunk
outputs.  The wrapper allocates their float32 scratch with ``torch.empty``:
the chunk states (B, S / L, H, N, P), 168 MB at mamba2-2.7b's B=2, S=4096,
and each chunk's summed log decay (B, S / L, H).
``ssd_scan.launches`` counts the wrapper's calls that launched the kernels.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import load_kernel
from .ref import ssd_ref

__all__ = ["ssd_scan", "MAX_TILE", "CUDA_LAUNCHES"]

MAX_TILE = 128              # the kernels' largest chunk L, d_state N, d_head P
CUDA_LAUNCHES = 3           # kernels a call launches
_DTYPES = (torch.float32, torch.bfloat16)


def _check(x, a, b, c) -> None:
    if x.dim() != 4 or b.dim() != 4:
        raise ValueError(f"ssd_scan takes 4-d x, b and c, got x "
                         f"{tuple(x.shape)}, b {tuple(b.shape)}")
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if tuple(a.shape) != (B, S, H) or tuple(b.shape) != (B, S, G, N) \
            or c.shape != b.shape:
        raise ValueError(
            f"ssd_scan operand shapes disagree: x {tuple(x.shape)}, a "
            f"{tuple(a.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}")
    if G == 0 or H % G != 0:
        raise ValueError(f"ssd_scan needs heads % groups == 0, got H={H}, "
                         f"G={G}")
    for name, t in (("a", a), ("b", b), ("c", c)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """Chunked SSD scan; (B, S, H, P) out, x's type."""
    _check(x, a, b, c)
    if x.device.type == "cpu":
        return ssd_ref(x, a, b, c)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, a, b, c)):
        raise RuntimeError(
            "ssd_scan has no backward kernel yet: its CUDA path cannot give "
            "a gradient (the plain CPU path can)")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the ssd_scan kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    for name, t in (("b", b), ("c", c)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype} but x is {x.dtype}")
    if not a.is_floating_point():
        raise TypeError(f"a must be floating point, got {a.dtype}")
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if x.numel() == 0:
        return torch.empty_like(x)
    L = min(chunk, S)
    if L < 1 or L > MAX_TILE or N > MAX_TILE or P > MAX_TILE:
        raise ValueError(
            f"the ssd_scan kernel takes chunk, d_state and d_head in "
            f"1..{MAX_TILE}, got L={L}, N={N}, P={P}")
    pad = (-S) % L
    if pad:
        # padded steps use decay 1 (log 0) and zero inputs: state unchanged
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad), value=1.0)
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous "
                             f"(stride {t.stride(3)})")
    Sp = S + pad
    loga = torch.log(torch.clamp(a.float(), min=1e-37)).contiguous()
    y = torch.empty((B, Sp, H, P), dtype=x.dtype, device=x.device)
    nC = Sp // L
    states = torch.empty((B, nC, H, N, P), dtype=torch.float32,
                         device=x.device)
    decay = torch.empty((B, nC, H), dtype=torch.float32, device=x.device)
    lib = load_kernel("ssd_scan")
    fn = lib.ssd_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    strides = [t.stride(i) for t in (x, b, c) for i in range(3)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), loga.data_ptr(), b.data_ptr(), c.data_ptr(),
                 y.data_ptr(), states.data_ptr(), decay.data_ptr(),
                 int(x.dtype == torch.bfloat16), B, Sp, H, G, P, N, L,
                 *strides, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    ssd_scan.launches += 1
    return y[:, :S]


ssd_scan.launches = 0

"""Wrappers for the ssd_scan kernel (K5) and its backward: checks, chunk
padding, dispatch by device, autograd and the launch counters.

``ssd_scan`` computes what ``repro/kernels/ssd_scan/ops.py::ssd_scan``
computes, the Mamba2 SSD scan over x (B, S, H, P), the decay a (B, S, H)
and the state-group inputs b, c (B, S, G, N).  A CPU tensor takes the plain
version (``ref.ssd_ref``, the sequential recurrence); a CUDA tensor
launches the kernels in ``csrc/ssd_scan.cu`` or raises.  Before the launch
it does what the reference's wrapper does: L = min(chunk, S), x, b and c
padded with zeros and a with 1 to a multiple of L (padded steps leave the
state unchanged), loga = log(max(a, 1e-37)) in float32, the output sliced
back to S.  The reference falls back to its oracle past 2^31 - 1 elements
because Pallas indexes in int32; these kernels index with 64-bit
offsets, so that guard has no counterpart here.  The extents (B, S, H, G,
P, N and the chunk) go to them as C ints, so one past 2^31 - 1 (S past
2^31 - 1 - 128, room for the padding) raises, on every device.

The kernels read x, b and c through their (batch, seq, head or group)
strides, so the views that ``models.ssm`` splits out of one projection
need no copy; only the last dim must be contiguous.  They take L, N and P
up to 128 and float32 or bfloat16 inputs (x, b and c of one type).  One
call launches ``CUDA_LAUNCHES[dtype]`` kernels on the current stream.
bfloat16: one, the chunk walk (``ssd_walk_wgmma``: a block a (batch, head,
64 columns of P) walking the chunks with the state on chip, every product
on wgmma); it reads x, b and c by TMA, so an operand whose base or (batch,
seq, head or group) stride is not a multiple of 16 bytes goes as a staged
copy (``kernels.tma``), counted on ``ssd_scan.staged``, and it
allocates no state scratch unless the states are kept.  float32:
three, chunk-parallel (chunk states, the state pass over the chunks, chunk
outputs), through a float32 scratch from ``torch.empty``: the chunk states
(B, S / L, H, N, P) and each chunk's summed log decay (B, S / L, H).

When a gradient is wanted (grad mode on and an input that requires it),
``ssd_scan`` is a ``torch.autograd.Function`` whose backward is what
``jax.vjp`` of the reference's ``_ssd_chunked_jnp`` computes (``ref.py``
writes it out).  On a card the forward keeps the state entering each chunk
(float32, 335 MB at B=4, S=4096; under remat "full" only the layer being
differentiated holds one) and each chunk's log decay, and the backward is
the kernels of
``csrc/ssd_scan_bwd.cu`` and ``csrc/ssd_scan_bwd_mma.cu`` (built into the
same library as the forward) behind two wrappers, which ``ssd_scan_bwd``
chains: ``ssd_bwd_state`` (the gradient of the state leaving each chunk)
and ``ssd_bwd_chunk`` (dx, da, db and dc a chunk, then db and dc summed
over each state group's partials in a fixed order).  bfloat16 runs on the
tensor cores: the state gradients in one launch that walks the chunks, and
the chunk gradients by blocks that each walk 8 heads of a group, so the
float32 partials are (B, S, G, ceil(heads a group / 8), N), 84 MB each at
mamba2's B=4.  float32 runs float32 FMAs: a chunk kernel and a reverse
pass, and per-head partials (B, S, H, N), 671 MB each.  ``BWD_KERNELS``
names each wrapper's kernels by type.  The three take CUDA tensors only.
On the CPU the forward keeps nothing and the backward is
``ref.ssd_bwd_ref``, the chunked backward in tensor ops.  Without a
gradient no autograd node is made and nothing is kept.  No atomics: a
gradient has the same bits on every run.

``ssd_scan.launches`` counts the forward's calls that launched its kernels;
``ssd_bwd_state.launches`` and ``ssd_bwd_chunk.launches`` the backward's
(one each a backward on a card, whatever the CUDA launches a call makes).
"""
from __future__ import annotations

import ctypes

import torch

from .. import PLAIN_DEVICES, load_kernel
from ..tma import tma_operands, tma_strides
from .ref import log_decay, pad_chunks, ssd_bwd_ref, ssd_ref

__all__ = ["ssd_scan", "ssd_scan_bwd", "ssd_bwd_state", "ssd_bwd_chunk",
           "MAX_TILE", "CUDA_LAUNCHES", "BWD_KERNELS"]

MAX_TILE = 128              # the kernels' largest chunk L, d_state N, d_head P
# CUDA kernels a forward call launches, by type: bf16 the chunk walk,
# float32 chunk states, the state pass and chunk outputs
CUDA_LAUNCHES = {torch.bfloat16: 1, torch.float32: 3}
# the kernels each backward wrapper launches, in order, by their numbers in
# csrc/ssd_scan_bwd.cu's table of the backward's kernels (``bwd_kernel``,
# read through ``ssd_bwd_kernel_name`` and ``ssd_bwd_attributes``)
BWD_KERNELS = {torch.bfloat16: {"ssd_bwd_state": (5,),
                                "ssd_bwd_chunk": (6, 7, 8, 9)},
               torch.float32: {"ssd_bwd_state": (1, 2),
                               "ssd_bwd_chunk": (3, 4)}}
_DTYPES = (torch.float32, torch.bfloat16)
_I32_MAX = 2**31 - 1        # the extents go to the kernels as C ints


def _extents_error(name: str, x: torch.Tensor, b: torch.Tensor) -> str:
    return (f"{name} takes every extent up to 2^31 - 1 (its kernels' int "
            f"arguments; S up to 2^31 - 1 - {MAX_TILE}, room for a chunk's "
            f"padding), got x {tuple(x.shape)}, b {tuple(b.shape)}")


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


def _check_cuda(x, a, b, c, chunk: int) -> int:
    """The kernels' own limits; returns L."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu, meta or cuda, not "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"the ssd_scan kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    for name, t in (("b", b), ("c", c)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype} but x is {x.dtype}")
    if not a.is_floating_point():
        raise TypeError(f"a must be floating point, got {a.dtype}")
    S = x.shape[1]
    N, P = b.shape[3], x.shape[3]
    L = min(chunk, S)
    if x.numel() and (L < 1 or L > MAX_TILE or N > MAX_TILE
                      or P > MAX_TILE):
        raise ValueError(
            f"the ssd_scan kernel takes chunk, d_state and d_head in "
            f"1..{MAX_TILE}, got L={L}, N={N}, P={P}")
    return L


def _contiguous_last(**tensors) -> None:
    for name, t in tensors.items():
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous "
                             f"(stride {t.stride(3)})")


def _strides(*tensors) -> list[int]:
    return [t.stride(i) for t in tensors for i in range(3)]


def _cuda_only(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} launches CUDA kernels, got a tensor on "
                         f"{t.device}; ssd_scan's backward takes "
                         f"ref.ssd_bwd_ref on the CPU")


def _launch(fn, name: str, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _forward(x, a, b, c, chunk: int, keep: bool):
    """(y, kept): kept is (loga, states, decay) on a card when `keep`, the
    forward's log decay and scratch (states: the state entering each chunk,
    (B, nC, H, N, P) float32; decay: each chunk's summed log decay; three
    Nones for an empty x), else ()."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if max(B, S + MAX_TILE, H, G, P, N) > _I32_MAX:
        raise ValueError(_extents_error("ssd_scan", x, b))
    if x.device.type in PLAIN_DEVICES:
        return ssd_ref(x, a, b, c), ()
    L = _check_cuda(x, a, b, c, chunk)
    if x.numel() == 0:
        return torch.empty_like(x), ((None,) * 3 if keep else ())
    if not 1 <= L <= MAX_TILE:     # _check_cuda's limit, where it is used
        raise ValueError(f"ssd_scan's chunk is {L}")
    x, a, b, c = pad_chunks(L, x, a, b, c)
    _contiguous_last(x=x, b=b, c=c)
    Sp = S + (-S) % L              # x.shape[1]: S padded to chunks
    loga = log_decay(a.float()).contiguous()
    y = torch.empty((B, Sp, H, P), dtype=x.dtype, device=x.device)
    nC = Sp // L
    bf16 = x.dtype == torch.bfloat16
    # float32's three kernels pass the states through this scratch; the
    # bf16 walk keeps its state on chip and writes them only when kept
    if keep or not bf16:
        states = torch.empty((B, nC, H, N, P), dtype=torch.float32,
                             device=x.device)
        decay = torch.empty((B, nC, H), dtype=torch.float32, device=x.device)
    else:
        states = decay = None
    if bf16:
        # each operand TMA cannot describe as it lies goes as a staged
        # copy, counted on ssd_scan.staged
        x, b, c = tma_operands(ssd_scan, x, b, c)
        strides = [st for t in (x, b, c) for st in tma_strides(t)]
    else:
        strides = _strides(x, b, c)
    fn = load_kernel("ssd_scan").ssd_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _launch(fn, "ssd_scan", x.device, x.data_ptr(), loga.data_ptr(),
            b.data_ptr(), c.data_ptr(), y.data_ptr(),
            states.data_ptr() if states is not None else None,
            decay.data_ptr() if decay is not None else None, int(bf16), B,
            Sp, H, G, P, N, L, *strides)
    ssd_scan.launches += 1
    return y[:, :S], ((loga, states, decay) if keep else ())


class _SSDScan(torch.autograd.Function):
    """The scan, and its gradient in x, a, b and c."""

    @staticmethod
    def forward(ctx, x, a, b, c, chunk: int):
        # the CPU's backward (ssd_bwd_ref) recomputes what it needs
        y, kept = _forward(x, a, b, c, chunk, x.device.type == "cuda")
        ctx.save_for_backward(x, a, b, c, *kept)
        ctx.chunk = chunk
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, a, b, c, *kept = ctx.saved_tensors
        if x.device.type in PLAIN_DEVICES:
            return (*ssd_bwd_ref(x, a, b, c, dy, chunk=ctx.chunk), None)
        return (*ssd_scan_bwd(x, a, b, c, dy, *kept, chunk=ctx.chunk), None)


def ssd_scan(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, *, chunk: int = 128) -> torch.Tensor:
    """Chunked SSD scan; (B, S, H, P) out, x's type.  Differentiable in x,
    a, b and c."""
    _check(x, a, b, c)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, a, b, c)):
        return _SSDScan.apply(x, a, b, c, int(chunk))
    return _forward(x, a, b, c, int(chunk), False)[0]


ssd_scan.launches = 0
ssd_scan.staged = 0


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def ssd_bwd_state(c: torch.Tensor, dy: torch.Tensor, loga: torch.Tensor,
                  decay: torch.Tensor, *, chunk: int) -> torch.Tensor:
    """G_c (B, nC, H, N, P) float32, the gradient of the state leaving each
    chunk, from c (B, S, G, N), dy (B, S, H, P), loga (B, S, H) and the
    forward's decay (B, nC, H), S a multiple of `chunk` (``BWD_KERNELS``
    names the kernels; for bfloat16 G comes rounded to TF32, as the chunk
    kernel's products take it), CUDA tensors only (dy and c of one type; c
    through its strides, the rest dense).  Its plain version is
    ``ref.ssd_bwd_state_ref``."""
    B, S, H, P = dy.shape
    G, N = c.shape[2], c.shape[3]
    if max(B, S, H, G, P, N) > _I32_MAX or not 1 <= chunk <= MAX_TILE:
        raise ValueError(_extents_error("ssd_bwd_state", dy, c)
                         + f", chunk {chunk}")
    _cuda_only("ssd_bwd_state", c)
    if not (dy.is_contiguous() and loga.is_contiguous()
            and decay.is_contiguous()):
        raise ValueError("ssd_bwd_state takes dense dy, loga and decay")
    if c.dtype != dy.dtype or c.dtype not in _DTYPES \
            or loga.dtype != torch.float32:
        raise TypeError(f"ssd_bwd_state takes c and dy of one type (float32 "
                        f"or bfloat16) and float32 loga, got {c.dtype}, "
                        f"{dy.dtype}, {loga.dtype}")
    _contiguous_last(c=c)
    grads = torch.empty((B, S // chunk, H, N, P), dtype=torch.float32,
                        device=c.device)
    if grads.numel() == 0:
        return grads
    fn = load_kernel("ssd_scan").ssd_bwd_state_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _launch(fn, "ssd_bwd_state", c.device, c.data_ptr(), dy.data_ptr(),
            loga.data_ptr(), decay.data_ptr(), grads.data_ptr(),
            int(c.dtype == torch.bfloat16), B, S, H, G, P, N, chunk,
            *_strides(c))
    ssd_bwd_state.launches += 1
    return grads


ssd_bwd_state.launches = 0


def ssd_bwd_chunk(x, a, loga, b, c, dy, states, grads, *, chunk: int):
    """(dx, da, db, dc) from x (B, S, H, P), a and loga (B, S, H), b and c
    (B, S, G, N), dy (B, S, H, P), the states entering the chunks and the
    gradients leaving them ((B, nC, H, N, P) float32), S a multiple of
    `chunk`: dx in x's type, da in loga's, db and dc in b's, summed over
    each group's heads.  The kernels ``BWD_KERNELS`` names (bf16: four,
    float32: two), CUDA tensors only (x, b, c through their strides; a
    float32; the rest dense).  Its plain version is
    ``ref.ssd_bwd_chunk_ref``."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if max(B, S, H, G, P, N) > _I32_MAX or not 1 <= chunk <= MAX_TILE:
        raise ValueError(_extents_error("ssd_bwd_chunk", x, b)
                         + f", chunk {chunk}")
    _cuda_only("ssd_bwd_chunk", x)
    if not all(t.is_contiguous() for t in (a, loga, dy, states, grads)):
        raise ValueError("ssd_bwd_chunk takes dense a, loga, dy, states and "
                         "grads")
    if a.dtype != torch.float32 or loga.dtype != torch.float32 \
            or states.dtype != torch.float32 or grads.dtype != torch.float32:
        raise TypeError("ssd_bwd_chunk takes float32 a, loga, states and "
                        "grads")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (b, c, dy)):
        raise TypeError(f"ssd_bwd_chunk takes x, b, c and dy of one type "
                        f"(float32 or bfloat16), got {x.dtype}, {b.dtype}, "
                        f"{c.dtype}, {dy.dtype}")
    _contiguous_last(x=x, b=b, c=c)
    dev = x.device
    dx = torch.empty((B, S, H, P), dtype=x.dtype, device=dev)
    da = torch.empty((B, S, H), dtype=torch.float32, device=dev)
    db = torch.empty((B, S, G, N), dtype=b.dtype, device=dev)
    dc = torch.empty((B, S, G, N), dtype=b.dtype, device=dev)
    if dx.numel() == 0 or db.numel() == 0:
        return dx.zero_(), da.zero_(), db.zero_(), dc.zero_()
    lib = load_kernel("ssd_scan")
    is_bf16 = int(x.dtype == torch.bfloat16)
    lib.ssd_bwd_parts.argtypes = [ctypes.c_int] * 3
    lib.ssd_bwd_parts.restype = ctypes.c_int
    parts = lib.ssd_bwd_parts(is_bf16, H, G)
    dbp = torch.empty((B, S, G, parts, N), dtype=torch.float32, device=dev)
    dcp = torch.empty_like(dbp)
    # the suffix term of dla, which the bf16 chunk kernel adds in its last
    # launch (float32 does not read it)
    dsuf = torch.empty((B, S, H) if is_bf16 else (0,), dtype=torch.float32,
                       device=dev)
    fn = lib.ssd_bwd_chunk_launch
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _launch(fn, "ssd_bwd_chunk", dev, x.data_ptr(), a.data_ptr(),
            loga.data_ptr(), b.data_ptr(), c.data_ptr(), dy.data_ptr(),
            states.data_ptr(), grads.data_ptr(), dx.data_ptr(),
            da.data_ptr(), dsuf.data_ptr(), dbp.data_ptr(), dcp.data_ptr(),
            db.data_ptr(), dc.data_ptr(), is_bf16, B, S, H, G, P, N, chunk,
            *_strides(x, b, c))
    ssd_bwd_chunk.launches += 1
    return dx, da, db, dc


ssd_bwd_chunk.launches = 0


def ssd_scan_bwd(x, a, b, c, dy, loga, states, decay, *, chunk: int = 128):
    """(dx, da, db, dc) of ``ssd_scan(x, a, b, c, chunk=chunk)`` at `dy`,
    each in its input's type, from what the card's forward kept (``_forward
    (..., keep=True)``: loga, states, decay), through ``ssd_bwd_state`` and
    ``ssd_bwd_chunk``.  CUDA tensors only; the CPU's backward is
    ``ref.ssd_bwd_ref``."""
    _cuda_only("ssd_scan_bwd", x)
    _check(x, a, b, c)
    if tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"dy is {tuple(dy.shape)}, x {tuple(x.shape)}")
    L = _check_cuda(x, a, b, c, chunk)
    S = x.shape[1]
    if x.numel() == 0 or b.numel() == 0:
        return (torch.zeros_like(x), torch.zeros_like(a), torch.zeros_like(b),
                torch.zeros_like(c))
    x, a, b, c, dy = pad_chunks(L, x, a, b, c, dy.to(x.dtype))
    dy = dy.contiguous()
    af = a.float().contiguous()
    grads = ssd_bwd_state(c, dy, loga, decay, chunk=L)
    dx, da, db, dc = ssd_bwd_chunk(x, af, loga, b, c, dy, states, grads,
                                   chunk=L)
    return dx[:, :S], da[:, :S].to(a.dtype), db[:, :S], dc[:, :S]


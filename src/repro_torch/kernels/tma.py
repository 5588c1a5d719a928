"""What the bf16 kernels that read their operands by TMA ask of a tensor,
shared by the flash_attention and ssd_scan wrappers.

A TMA tensor map describes an operand as it lies: a contiguous last dim, a
base and strides that are multiples of 16 bytes (``tma_describable``).  An
operand that is not (a view offset by an element, a last dim of odd bytes)
goes to its kernel as a staged copy (``tma_staged``: contiguous, each row
of the last dim padded to 16 bytes), counted on its wrapper's ``staged``
(``tma_operands``).  The choice is made from the layout before the launch,
never after a failure.
"""
from __future__ import annotations

import torch

__all__ = ["TMA_ALIGN", "tma_describable", "tma_strides", "tma_staged",
           "tma_operands"]

TMA_ALIGN = 16              # bytes: a TMA base address and stride


def tma_describable(t: torch.Tensor) -> bool:
    """Whether a 4-d operand can be read by TMA as it lies: a contiguous
    last dim, a 16-byte aligned base, and a stride on each of the first
    three dims that is a positive multiple of 16 bytes wherever the dim is
    longer than 1 (a dim of length 1 is never stepped along)."""
    es = t.element_size()
    if t.data_ptr() % TMA_ALIGN or (t.shape[3] > 1 and t.stride(3) != 1):
        return False
    return all(n == 1 or (st > 0 and st * es % TMA_ALIGN == 0)
               for n, st in zip(t.shape[:3], t.stride()[:3]))


def tma_strides(t: torch.Tensor) -> list[int]:
    """t's strides on its first three dims in elements, for its tensor map;
    a dim of length 1 takes the extent of the whole tensor, rounded up to
    16 bytes, since its stride is never stepped along but must still be a
    multiple of 16 bytes."""
    unit = TMA_ALIGN // t.element_size()
    extent = max(n * st for n, st in zip(t.shape, t.stride()))
    packed = -(-extent // unit) * unit
    return [st if n > 1 else packed
            for n, st in zip(t.shape[:3], t.stride()[:3])]


def tma_staged(t: torch.Tensor) -> torch.Tensor:
    """A copy of t that TMA can describe: contiguous, each row of its last
    dim padded to a multiple of 16 bytes (the padding is never read: the
    tensor map's width is the row's length)."""
    unit = TMA_ALIGN // t.element_size()
    n = t.shape[-1]
    buf = t.new_empty((*t.shape[:-1], -(-n // unit) * unit))
    view = buf[..., :n]
    view.copy_(t)
    return view


def tma_operands(wrapper, *tensors) -> list[torch.Tensor]:
    """The operands as a TMA kernel reads them: each one TMA cannot
    describe as it lies replaced by its staged copy, counted on
    ``wrapper.staged``."""
    out = []
    for t in tensors:
        if not tma_describable(t):
            t = tma_staged(t)
            wrapper.staged += 1
        out.append(t)
    return out

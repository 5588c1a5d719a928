"""Simulated gradient compression (quantise-dequantise), the port of
``repro.dist.compression``.

Symmetric per-tensor quantisation of every floating-point leaf of the
gradient tree to ``bits`` levels, applied before the optimizer update: the
all-reduce payload the collective planner schedules is the compressed one,
and the round-trip error is what training absorbs.  Other leaves pass
through.  ``torch.round``, like ``jnp.round``, rounds half to even.
"""
from __future__ import annotations

import torch

from ..models.lm import tree_map

__all__ = ["compress_decompress"]


def compress_decompress(grads, bits: int = 8):
    """Quantise-dequantise every float leaf of `grads` (a tensor or a
    nested dict of tensors) to `bits` levels; new tensors, inputs
    unchanged."""
    qmax = float(2 ** (bits - 1) - 1)

    def q(g: torch.Tensor) -> torch.Tensor:
        if not g.is_floating_point():
            return g
        amax = torch.max(torch.abs(g))
        scale = torch.where(amax > 0, amax / qmax,
                            torch.ones((), dtype=amax.dtype,
                                       device=amax.device)).to(g.dtype)
        return (torch.clamp(torch.round(g / scale), -qmax, qmax)
                * scale).to(g.dtype)

    return tree_map(q, grads)

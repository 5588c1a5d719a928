"""Plain PyTorch version of the bna_step kernel: one lock-step iteration of
Algorithm 1 in filled-matrix form across a (B, w, w) demand stack.

It is the port's copy of ``repro.core.matching.bna_step_inplace`` (the
reference's single numpy source of the step formulas), written on tensors.
A CPU tensor runs it; ``chip_smoke.py`` holds the CUDA kernel against it on
the card.  All-integer arithmetic, so agreement is equality.  It works in
the state's own type, int32 or int64, with that type's largest value as
the sentinel (the reference's int32 kernel and int64 numpy step do the
same).
"""
from __future__ import annotations

import torch

NO_MATCH = -1


def bna_step_ref(
    d: torch.Tensor,      # (B, w, w) remaining demands, mutated
    row: torch.Tensor,    # (B, w) row loads, mutated
    col: torch.Tensor,    # (B, w) col loads, mutated
    D: torch.Tensor,      # (B,) remaining effective sizes, mutated
    match: torch.Tensor,  # (B, w) match_sr (-1 = unmatched)
) -> torch.Tensor:
    """One batched step, in place on d/row/col/D (all int32, or all
    int64).  Returns the packed (B, 2 + 2w) rows, in the same type, ``[t | D' | piece | invalid]``: t the step
    length (0 for drained matrices), piece the real matched edges
    transmitted (-1 elsewhere), invalid the matched edges that left the
    filled graph (the scalar repair()'s bad mask, masked to D' > 0)."""
    BIG = torch.iinfo(d.dtype).max
    midx = match.clamp(min=0).long()
    dm = d.gather(2, midx[:, :, None])[:, :, 0]
    real = (match != NO_MATCH) & (dm > 0)
    t = torch.where(real, dm, BIG).amin(dim=1)
    t = torch.minimum(t, torch.where(~real, D[:, None] - row, BIG).amin(dim=1))
    recv = torch.zeros_like(real)
    bi, si = torch.nonzero(real, as_tuple=True)
    ri = midx[bi, si]
    recv[bi, ri] = True
    t = torch.minimum(t, torch.where(~recv, D[:, None] - col, BIG).amin(dim=1))
    piece = torch.where(real, match, NO_MATCH)
    # transmit t units on every real matched edge
    d[bi, si, ri] -= t[bi]
    row -= t[:, None] * real
    col -= t[:, None] * recv
    D -= t
    dm2 = d.gather(2, midx[:, :, None])[:, :, 0]
    colm = col.gather(1, midx)
    invalid = (match != NO_MATCH) & (dm2 == 0) \
        & ((row >= D[:, None]) | (colm >= D[:, None])) & (D > 0)[:, None]
    return torch.cat([t[:, None], D[:, None], piece,
                      invalid.to(d.dtype)], dim=1)


def unpack_step(out: torch.Tensor) -> tuple:
    """Split packed step rows into ``(t, D', piece, invalid)`` views."""
    w = (out.shape[1] - 2) // 2
    return out[:, 0], out[:, 1], out[:, 2:2 + w], out[:, 2 + w:]

"""Plain PyTorch versions of the Mamba2 SSD scan, the port's copy of
``repro/kernels/ssd_scan/ref.py``: the exact sequential recurrence.

State h_t (N, P) per (batch, head):
    h_t = a_t * h_{t-1} + b_t (N,) outer x_t (P,)
    y_t = c_t . h_t   (contract N)

a: per-head scalar decay in (0, 1]; b, c shared across heads within a state
group (n_groups, GQA-style).  A CPU tensor takes ``ssd_ref`` through the
wrapper; ``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch

__all__ = ["ssd_ref", "ssd_decode_step"]


def ssd_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, P); a: (B, S, H); b, c: (B, S, G, N).  Returns
    (B, S, H, P) in x's type; the recurrence runs in float32."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    bf = b.float().repeat_interleave(rep, dim=2)          # (B, S, H, N)
    cf = c.float().repeat_interleave(rep, dim=2)
    xf = x.float()
    af = a.float()
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = af[:, t, :, None, None] * h \
            + bf[:, t, :, :, None] * xf[:, t, :, None, :]
        ys.append(torch.einsum("bhn,bhnp->bhp", cf[:, t], h))
    if not ys:
        return x.new_empty((B, 0, H, P))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_decode_step(h: torch.Tensor, x_t: torch.Tensor, a_t: torch.Tensor,
                    b_t: torch.Tensor, c_t: torch.Tensor):
    """Single-token recurrence for serving.  h: (B, H, N, P) float32;
    x_t (B, H, P), a_t (B, H), b_t, c_t (B, G, N).  Returns (h, y), y in
    x_t's type."""
    rep = h.shape[1] // b_t.shape[1]
    bt = b_t.float().repeat_interleave(rep, dim=1)
    ct = c_t.float().repeat_interleave(rep, dim=1)
    h = a_t.float()[..., None, None] * h \
        + bt[..., :, None] * x_t.float()[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", ct, h)
    return h, y.to(x_t.dtype)

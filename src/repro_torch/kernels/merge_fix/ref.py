"""Plain PyTorch version of merge_fix: the classic merge_and_fix tail —
alphas from the edge activations, then the expanded interval durations
``len * max(alpha, 1)`` (Lemma 6).  The port's copy of
``repro/kernels/merge_fix/ref.py::merge_fix_ref``, on tensors.  A CPU
tensor runs it; ``chip_smoke.py`` holds the CUDA kernel against it on the
card."""
from __future__ import annotations

import torch

from ..coflow_merge.ref import alphas_ref, build_delta


def merge_fix_ref(
    events: torch.Tensor,  # (K+1,) int64 sorted unique interval boundaries
    t0: torch.Tensor,      # (E,) int64 edge activation start times
    t1: torch.Tensor,      # (E,) int64 edge activation end times (exclusive)
    s: torch.Tensor,       # (E,) int64 sender port
    r: torch.Tensor,       # (E,) int64 receiver port
    m: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (alphas (K,) int64, deltas (K,) int64); the deltas cumsum to
    merge_and_fix's ``exp`` (before the origin shift)."""
    K = int(events.numel()) - 1
    if K < 1:
        z = torch.zeros(0, dtype=torch.int64, device=events.device)
        return z, z.clone()
    si = torch.searchsorted(events, t0)
    ei = torch.searchsorted(events, t1)
    alphas = alphas_ref(build_delta(si, ei, s, r, K, m)).to(torch.int64)
    lens = events[1:] - events[:-1]
    return alphas, lens * alphas.clamp(min=1)

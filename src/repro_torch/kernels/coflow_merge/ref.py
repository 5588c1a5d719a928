"""Plain PyTorch version of coflow_merge: scatter the edge activations into
the (K, 2m) delta array, take the running count down the interval axis,
then the max over ports — alpha_t of DMA Steps 3-4 (the quantity Lemma 4
bounds).  The port's copy of ``repro/kernels/coflow_merge/ref.py``."""
from __future__ import annotations

import torch


def build_delta(si: torch.Tensor, ei: torch.Tensor, s: torch.Tensor,
                r: torch.Tensor, K: int, m: int) -> torch.Tensor:
    """(K, 2m) int32 count deltas: +1 where an edge activation starts on a
    port, -1 where it ends (senders in columns [0, m), receivers after).
    Runs on the tensors' device; the accumulation is integer, so its order
    cannot change the result."""
    delta = torch.zeros((K + 1, 2 * m), dtype=torch.int32, device=si.device)
    one = torch.ones_like(si, dtype=torch.int32)
    delta.index_put_((si, s), one, accumulate=True)
    delta.index_put_((ei, s), -one, accumulate=True)
    delta.index_put_((si, m + r), one, accumulate=True)
    delta.index_put_((ei, m + r), -one, accumulate=True)
    return delta[:K]


def alphas_ref(delta: torch.Tensor) -> torch.Tensor:
    """delta: (K, 2m) int32 count deltas.  Returns (K,) int32 alphas."""
    return delta.cumsum(dim=0).amax(dim=1).to(torch.int32)

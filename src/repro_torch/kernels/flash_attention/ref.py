"""Plain PyTorch version of the flash_attention kernel: exact softmax GQA
attention in float32, the port's copy of
``repro/kernels/flash_attention/ref.py::attention_ref``.

A CPU tensor takes it; ``chip_smoke.py`` holds the CUDA kernel against it
on the card.  Like the reference's oracle, a causal row whose every key is
masked (only possible when Sq > Sk) comes out NaN; the kernel, like the
Pallas kernel, is specified on the rows that see a key.
"""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, d); k, v: (B, Hkv, Sk, d); GQA by head repetition.
    The causal mask is aligned to the end of the keys: query i attends keys
    <= i + (Sk - Sq)."""
    B, Hq, Sq, d = q.shape
    _, Hkv, Sk, _ = k.shape
    group = Hq // Hkv
    if scale is None:
        scale = float(d) ** -0.5
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=Sk - Sq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)

"""Plain PyTorch versions of the flash_attention kernel and its backward.

``attention_ref`` is exact softmax GQA attention in float32, the port's copy
of ``repro/kernels/flash_attention/ref.py::attention_ref``.  Like the
reference's oracle, a causal row whose every key is masked (only possible
when Sq > Sk) comes out NaN; the kernel, like the Pallas kernel, is
specified on the rows that see a key.

``attention_lse_ref`` is each query row's log-sum-exp of the scaled, masked
scores (the forward's extra output when a gradient is wanted), -inf on a row
that sees no key.  ``attention_bwd_ref`` is the gradient of
``attention_ref``, the one ``jax.grad`` takes of the reference's plain
attention, computed in float32 and returned in the inputs' types; a row that
sees no key contributes nothing (its dq is 0) where the autodiff of
``attention_ref`` would give NaN.  ``attention_bwd_prep_ref`` is the
backward's row term D = rowsum(dO o O).

A CPU tensor takes these; ``chip_smoke.py`` holds the CUDA kernels against
them on the card.
"""
from __future__ import annotations

import torch


def _mask(Sq: int, Sk: int, device) -> torch.Tensor:
    """(Sq, Sk) True where query i sees key j: j <= i + (Sk - Sq)."""
    return torch.ones((Sq, Sk), dtype=torch.bool,
                      device=device).tril(diagonal=Sk - Sq)


def _scores(q, k, causal: bool, scale: float) -> torch.Tensor:
    """float32 (B, Hq, Sq, Sk) scaled scores, -inf where masked."""
    group = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    if causal:
        s = s.masked_fill(~_mask(q.shape[2], k.shape[2], q.device),
                          float("-inf"))
    return s


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, d); k, v: (B, Hkv, Sk, d); GQA by head repetition.
    The causal mask is aligned to the end of the keys: query i attends keys
    <= i + (Sk - Sq)."""
    group = q.shape[1] // k.shape[1]
    if scale is None:
        scale = float(q.shape[3]) ** -0.5
    vf = v.float().repeat_interleave(group, dim=1)
    s = _scores(q, k, causal, scale)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True,
                      scale: float | None = None) -> torch.Tensor:
    """(B, Hq, Sq) float32 log-sum-exp of each query row's scaled scores
    over the keys it sees; -inf on a row that sees none."""
    if scale is None:
        scale = float(q.shape[3]) ** -0.5
    return torch.logsumexp(_scores(q, k, causal, scale), dim=-1)


def attention_bwd_prep_ref(o: torch.Tensor,
                           dout: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO o O) in float32, (B, Hq, Sq)."""
    return (dout.float() * o.float()).sum(dim=-1)


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      dout: torch.Tensor, *, causal: bool = True,
                      scale: float | None = None):
    """(dq, dk, dv) of ``attention_ref`` at `dout`, in q's, k's and v's
    types: P = softmax(S), dV = P^T dO, dP = dO V^T, dS = P o (dP -
    rowsum(P o dP)), dQ = scale dS K, dK = scale dS^T Q, with dK and dV
    summed over each kv head's group of query heads."""
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if scale is None:
        scale = float(d) ** -0.5
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    den = p.sum(dim=-1, keepdim=True)
    p = p / torch.where(den > 0, den, 1.0)          # rows seeing no key: 0
    do = dout.float()
    vf = v.float().repeat_interleave(group, dim=1)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vf)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    kf = k.float().repeat_interleave(group, dim=1)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dk = dk.reshape(B, Hkv, group, Sk, d).sum(dim=2)
    dv = dv.reshape(B, Hkv, group, Sk, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)

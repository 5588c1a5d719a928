"""Plain PyTorch versions of the Mamba2 SSD scan and of its gradient.

``ssd_ref`` is the port's copy of ``repro/kernels/ssd_scan/ref.py``: the
exact sequential recurrence.  State h_t (N, P) per (batch, head):
    h_t = a_t * h_{t-1} + b_t (N,) outer x_t (P,)
    y_t = c_t . h_t   (contract N)

a: per-head scalar decay in (0, 1]; b, c shared across heads within a state
group (n_groups, GQA-style).  A CPU tensor takes ``ssd_ref`` through the
wrapper; ``chip_smoke.py`` holds the CUDA kernel against it on the card.

The gradient is what ``jax.vjp`` of the reference's ``_ssd_chunked_jnp``
(``repro/models/ssm.py``) computes, written as the chunked backward.  Per
(batch, head) and chunk of length L, with cum the in-chunk prefix sum of
la = log(max(a, 1e-37)), tot = cum[L-1], h_c the state entering chunk c
and G_c the gradient of the state leaving it (G_last = 0, G_(c-1) =
sum_i e^cum_i c_i dy_i^T + e^tot_c G_c):
    dx_j  = sum_(i>=j) (c_i.b_j) e^(cum_i-cum_j) dy_i + e^(tot-cum_j) G_c^T b_j
    db_j  = sum_(i>=j) (dy_i.x_j) e^(cum_i-cum_j) c_i + e^(tot-cum_j) G_c x_j
    dc_i  = sum_(j<=i) (dy_i.x_j) e^(cum_i-cum_j) b_j + e^cum_i h_c dy_i
    dla_t = sum_(i>=t>j) Q_ij + sum_(i>=t) e^cum_i dy_i.(h_c^T c_i)
            + sum_(j<t) e^(tot-cum_j) b_j^T G_c x_j + e^tot <h_c, G_c>
with Q_ij = (dy_i.x_j)(c_i.b_j) e^(cum_i-cum_j); db and dc summed over the
heads of each state group.  The decay's gradient goes through the floor of
la = log(max(a, 1e-37)): da = dla / a where a > 1e-37, and 0 at and under
the floor.  (There the reference's autodiff gives no usable number: its
dla, a sum of O(1) terms that cancel to O(a), is rounding noise, halved
and divided by 1e-37 at a tie (values near 1e30 in float32), and NaN once
exp(cum_i - cum_j) overflows above the diagonal, which la = -85.2 brings
about.)

The pieces mirror the CUDA wrappers in ``ops.py``: ``ssd_states_ref`` (the
forward's chunk states, which the card's forward keeps), ``ssd_bwd_state_ref``
(the G_c) and ``ssd_bwd_chunk_ref`` (dx, da, db, dc from them) take inputs
padded to a multiple of L; ``ssd_bwd_ref`` pads and chains them.  They run
in float32 (float64 for float64 inputs).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ssd_ref", "ssd_decode_step", "ssd_states_ref",
           "ssd_bwd_state_ref", "ssd_bwd_chunk_ref", "ssd_bwd_ref",
           "decay_grad", "log_decay", "pad_chunks"]

A_FLOOR = 1e-37             # la = log(max(a, A_FLOOR)), as the reference


def _work(t: torch.Tensor) -> torch.dtype:
    """The type a plain version computes in: float32, or float64."""
    return torch.promote_types(t.dtype, torch.float32)


def ssd_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, P); a: (B, S, H); b, c: (B, S, G, N).  Returns
    (B, S, H, P) in x's type; the recurrence runs in float32 (float64 for
    float64 inputs)."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    wt = _work(x)
    bf = b.to(wt).repeat_interleave(rep, dim=2)           # (B, S, H, N)
    cf = c.to(wt).repeat_interleave(rep, dim=2)
    xf = x.to(wt)
    af = a.to(wt)
    h = torch.zeros((B, H, N, P), dtype=wt, device=x.device)
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


def log_decay(a: torch.Tensor) -> torch.Tensor:
    """la = log(max(a, 1e-37)) in float32 (float64 for float64 a): the
    forward's and the backward's log decay."""
    return torch.log(torch.clamp(a.to(_work(a)), min=A_FLOOR))


def decay_grad(dla: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """da from dla through la = log(max(a, 1e-37)): dla / a above the
    floor, 0 at and under it."""
    af = a.to(dla.dtype)
    above = af > torch.tensor(A_FLOOR, dtype=af.dtype, device=af.device)
    return torch.where(above, dla / torch.where(above, af, 1.0), 0.0)


def pad_chunks(L: int, x, a, b, c, *rest):
    """x, a, b, c (and any (B, S, ...) tensors in rest) padded along S to a
    multiple of L: zeros, a with 1 (padded steps pass the state through)."""
    pad = (-x.shape[1]) % L
    if not pad:
        return (x, a, b, c, *rest)
    seq = lambda t: F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))  # noqa: E731
    return (seq(x), F.pad(a, (0, 0, 0, pad), value=1.0), seq(b), seq(c),
            *(seq(t) for t in rest))


def _cum(loga: torch.Tensor, L: int) -> torch.Tensor:
    B, Sp, H = loga.shape
    return torch.cumsum(loga.reshape(B, Sp // L, L, H), dim=2)


def _heads(t: torch.Tensor, rep: int, L: int, wt) -> torch.Tensor:
    """(B, Sp, G, N) -> (B, nC, L, H, N) in type wt, each group's rows
    repeated for its heads."""
    B, Sp, G, N = t.shape
    return t.to(wt).repeat_interleave(rep, dim=2).reshape(
        B, Sp // L, L, G * rep, N)


def ssd_states_ref(x: torch.Tensor, loga: torch.Tensor, b: torch.Tensor,
                   chunk: int):
    """The state entering each chunk, h_c (B, nC, H, N, P), each chunk's
    summed log decay tot_c (B, nC, H) and the final state (B, H, N, P),
    from inputs padded to a multiple of the chunk: the first two are what
    the forward's kernels 1 and 2 leave in their scratch."""
    B, Sp, H, P = x.shape
    L = chunk
    wt = loga.dtype
    cum = _cum(loga, L)
    tot = cum[:, :, -1, :]
    xf = x.to(wt).reshape(B, Sp // L, L, H, P)
    wb = _heads(b, H // b.shape[2], L, wt) \
        * torch.exp(tot[:, :, None, :] - cum)[..., None]
    s = torch.einsum("bclhn,bclhp->bchnp", wb, xf)
    h = torch.zeros_like(s[:, 0])
    h_in = []
    for ci in range(Sp // L):
        h_in.append(h)
        h = torch.exp(tot[:, ci])[..., None, None] * h + s[:, ci]
    return torch.stack(h_in, dim=1), tot, h


def ssd_bwd_state_ref(c: torch.Tensor, dy: torch.Tensor, loga: torch.Tensor,
                      decay: torch.Tensor, chunk: int) -> torch.Tensor:
    """G_c (B, nC, H, N, P), the gradient of the state leaving each chunk:
    the reverse pass G_last = 0, G_(c-1) = sum_i e^cum_i c_i dy_i^T +
    e^tot_c G_c, with tot_c from `decay` (B, nC, H).  Inputs padded to a
    multiple of the chunk."""
    B, Sp, H, P = dy.shape
    L = chunk
    wt = loga.dtype
    cum = _cum(loga, L)
    cf = _heads(c, H // c.shape[2], L, wt) * torch.exp(cum)[..., None]
    u = torch.einsum("bclhn,bclhp->bchnp", cf,
                     dy.to(wt).reshape(B, Sp // L, L, H, P))
    g = torch.zeros_like(u[:, 0])
    out = [None] * (Sp // L)
    for ci in reversed(range(Sp // L)):
        out[ci] = g
        g = u[:, ci] + torch.exp(decay[:, ci].to(wt))[..., None, None] * g
    return torch.stack(out, dim=1)


def ssd_bwd_chunk_ref(x, a, loga, b, c, dy, states, grads, chunk: int):
    """(dx, da, db, dc) from inputs padded to a multiple of the chunk, the
    states entering the chunks (``ssd_states_ref``) and the gradients
    leaving them (``ssd_bwd_state_ref``): dx in x's type (B, Sp, H, P), da
    in loga's (B, Sp, H), db and dc in b's (B, Sp, G, N), summed over each
    group's heads.  dla's first term is the sum over the rectangle i >= t
    > j, taken directly."""
    B, Sp, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    L, nC, rep = chunk, Sp // chunk, H // G
    wt = loga.dtype
    cum = _cum(loga, L)                                   # (B, nC, L, H)
    tot = cum[:, :, -1, :]
    xf = x.to(wt).reshape(B, nC, L, H, P)
    dyf = dy.to(wt).reshape(B, nC, L, H, P)
    bf, cf = _heads(b, rep, L, wt), _heads(c, rep, L, wt)
    h, g = states.to(wt), grads.to(wt)
    idx = torch.arange(L, device=x.device)
    lower = idx[:, None] >= idx[None, :]                  # i >= j
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B, nC, i, j, H)
    E = torch.exp(seg.masked_fill(~lower[None, None, :, :, None],
                                  float("-inf")))
    CB = torch.einsum("bcihn,bcjhn->bcijh", cf, bf)
    DX = torch.einsum("bcihp,bcjhp->bcijh", dyf, xf)
    w = torch.exp(tot[:, :, None, :] - cum)[..., None]   # e^(tot - cum_j)
    ecum = torch.exp(cum)[..., None]
    dx_inter = w * torch.einsum("bcjhn,bchnp->bcjhp", bf, g)
    db_inter = w * torch.einsum("bcjhp,bchnp->bcjhn", xf, g)
    dc_inter = ecum * torch.einsum("bcihp,bchnp->bcihn", dyf, h)
    dx = torch.einsum("bcijh,bcihp->bcjhp", CB * E, dyf) + dx_inter
    db = torch.einsum("bcijh,bcihn->bcjhn", DX * E, cf) + db_inter
    dc = torch.einsum("bcijh,bcjhn->bcihn", DX * E, bf) + dc_inter
    # dla_t: the pairs i >= t > j; the inter-chunk terms of y (i >= t) and
    # of the state (j < t); the carried state
    strict = idx[:, None] > idx[None, :]
    Q = CB * DX * E * strict[None, None, :, :, None]
    rect = ((idx[:, None, None] >= idx[None, None, :])
            & (idx[None, :, None] < idx[None, None, :])).to(wt)  # (i, j, t)
    term1 = torch.einsum("bcijh,ijt->bcth", Q, rect)
    inter_y = (dc_inter * cf).sum(-1)                     # (B, nC, L, H)
    term2 = torch.flip(torch.cumsum(torch.flip(inter_y, [2]), 2), [2])
    inter_s = (db_inter * bf).sum(-1)
    term3 = torch.cumsum(inter_s, 2) - inter_s
    term4 = torch.exp(tot) * (h * g).sum((-1, -2))        # (B, nC, H)
    dla = (term1 + term2 + term3 + term4[:, :, None, :]).reshape(B, Sp, H)
    group = lambda t: t.reshape(B, Sp, G, rep, N).sum(3).to(b.dtype)  # noqa
    return (dx.reshape(B, Sp, H, P).to(x.dtype), decay_grad(dla, a),
            group(db), group(dc))


def ssd_bwd_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, dy: torch.Tensor, *, chunk: int = 128):
    """(dx, da, db, dc) of ``ssd_ref(x, a, b, c)`` at `dy`, the chunked
    backward in tensor ops, each in its input's type.  L = min(chunk, S)
    and the padding as the forward's wrapper."""
    B, S, H, P = x.shape
    if x.numel() == 0 or b.numel() == 0:
        return (torch.zeros_like(x), torch.zeros_like(a), torch.zeros_like(b),
                torch.zeros_like(c))
    L = min(chunk, S)
    xp, ap, bp, cp, dyp = pad_chunks(L, x, a, b, c, dy)
    loga = log_decay(ap)
    states, decay, _ = ssd_states_ref(xp, loga, bp, L)
    grads = ssd_bwd_state_ref(cp, dyp, loga, decay, L)
    dx, da, db, dc = ssd_bwd_chunk_ref(xp, ap, loga, bp, cp, dyp, states,
                                       grads, L)
    return (dx[:, :S], da[:, :S].to(a.dtype), db[:, :S], dc[:, :S])

"""Transformer building blocks, the port of ``repro.models.layers``: RMSNorm,
RoPE, GQA attention, decode attention against a cache, SwiGLU MLP.  All
functional; parameters are plain dicts of tensors, in the reference's
layout ((d_in, d_out) weight matrices, activations (B, S, H, d)).

``attention`` dispatches by device: a CUDA tensor goes through the
flash_attention kernel (K4), a CPU tensor through the plain version the
reference takes off the TPU (``_attn_ref``, or ``_attn_chunked`` for long
sequences; both compute the same function).  ``cfg.attn_impl`` chooses no
path.  The reference's ``shard`` annotations are kept at its places
(``models/sharding.py``: no-ops outside a mesh).  Under a mesh, attention
runs on each rank's local shards (``sharding.sharded_call``): batch over
the dp axes, heads over "model"; a ``meta`` tensor (the dry run) takes the
plain version, as the CPU does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# repro: allow(backend-dispatch): K4 is the NN stack's own kernel, dispatched by its tensors' device, not scheduler backend dispatch
from ..kernels.flash_attention import flash_attention
from .common import DTYPES, ArchConfig
from .sharding import (fit_spec, index_on, is_dtensor, logical_spec,
                       mesh_axis_size, merge_dims, placements, reduce_partial,
                       shard, sharded_call, split_dim, sum_partial_grad)

__all__ = ["rms_norm", "rope", "attention", "decode_attention", "swiglu",
           "init_attn", "init_mlp", "init_norm", "attn_block", "mlp_block"]

NEG_INF = -1e30


def randn(shape: tuple, gen: "torch.Generator | None",
          device: "torch.device | str", std: float, dtype) -> torch.Tensor:
    """Normal(0, std^2) draws in float32 from `gen`, cast to `dtype` (scaled
    in place: one float32 copy of the leaf at a time).  On the ``meta``
    device (shapes only) no generator is needed."""
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(std).to(dtype)


def init_norm(d: int, dtype, lead: tuple = (), *, device) -> dict:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rms_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    # under a mesh a norm is where the residual stream is made whole, as
    # in Megatron: a Partial sum (a row-split product's output) is summed
    # here, and so is the gradient that comes back from the column-split
    # products its output feeds; left Partial, DTensor would carry it into
    # those products and gather their weights instead
    x = reduce_partial(x)
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return sum_partial_grad(
        (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"].to(x.dtype))


def _head_rms(x: torch.Tensor, eps: float) -> torch.Tensor:
    """qk_norm: RMS over the head dim (qwen3), no learned scale."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, d); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs                 # (..., S, half)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)             # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def init_attn(cfg: ArchConfig, gen: "torch.Generator | None",
              lead: tuple = (), *, device) -> dict:
    """One attention layer's parameters (with a leading `lead` shape, e.g.
    (n_periods,) for the stacked stack), drawn as the reference draws them:
    N(0, 1) scaled by d^-0.5 (wq, wk, wv) and (Hq dh)^-0.5 (wo)."""
    dt = DTYPES[cfg.param_dtype]
    d, dh = cfg.d_model, cfg.d_head
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    s = d ** -0.5
    p = {
        "norm": init_norm(d, dt, lead, device=device),
        "wq": randn((*lead, d, hq * dh), gen, device, s, dt),
        "wk": randn((*lead, d, hkv * dh), gen, device, s, dt),
        "wv": randn((*lead, d, hkv * dh), gen, device, s, dt),
        "wo": randn((*lead, hq * dh, d), gen, device, (hq * dh) ** -0.5, dt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, hq * dh), dtype=dt, device=device)
        p["bk"] = torch.zeros((*lead, hkv * dh), dtype=dt, device=device)
        p["bv"] = torch.zeros((*lead, hkv * dh), dtype=dt, device=device)
    return p


def _qkv(cfg: ArchConfig, p: dict, x: torch.Tensor, positions: torch.Tensor,
         rope_on: bool = True):
    B, S, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = split_dim(q, 2, (hq, dh))
    k = split_dim(k, 2, (hkv, dh))
    v = split_dim(v, 2, (hkv, dh))
    if cfg.qk_norm:
        q = _head_rms(q, cfg.norm_eps)
        k = _head_rms(k, cfg.norm_eps)
    if rope_on:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = shard(q, ("dp", None, "model", None))
    k = shard(k, ("dp", None, "model", None))
    v = shard(v, ("dp", None, "model", None))
    return q, k, v


def _attn_ref(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    """(B, S, H, d) layout einsum attention (small sequences)."""
    group = q.shape[2] // k.shape[2]
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        mask = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=Sk - Sq)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def _attn_chunked(q, k, v, causal: bool, scale: float,
                  chunk: int) -> torch.Tensor:
    """Flash-style online softmax as a loop over key blocks, in plain tensor
    ops (the memory profile of the kernel; long sequences on the CPU)."""
    B, Sq, Hq, d = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    C = min(chunk, Sk)
    pad = (-Sk) % C
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nk = k.shape[1] // C
    qf = q.float()
    offs = Sk - Sq
    acc = torch.zeros((B, Hq, Sq, d), dtype=torch.float32, device=q.device)
    mx = torch.full((B, Hq, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    den = torch.zeros((B, Hq, Sq), dtype=torch.float32, device=q.device)
    qpos = torch.arange(Sq, device=q.device)[:, None] + offs
    for ik in range(nk):
        kc = k[:, ik * C:(ik + 1) * C].float().repeat_interleave(group, dim=2)
        vc = v[:, ik * C:(ik + 1) * C].float().repeat_interleave(group, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kc) * scale
        kpos = ik * C + torch.arange(C, device=q.device)[None, :]
        valid = kpos < Sk
        if causal:
            valid = valid & (qpos >= kpos)
        s = torch.where(valid[None, None], s, NEG_INF)
        m_new = torch.maximum(mx, s.amax(dim=-1))
        pexp = torch.exp(s - m_new[..., None])
        corr = torch.exp(mx - m_new)
        den = den * corr + pexp.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", pexp, vc)
        mx = m_new
    out = acc / torch.clamp(den, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)               # (B, Sq, Hq, d)


def _sharded_attention(cfg: ArchConfig, q, k, v, causal: bool):
    """`attention` on each rank's local shards: batch over the dp axes and
    q heads over "model" where they divide (the reference's ``shard`` of q,
    k and v).  When the kv heads do not split the model axis (8 kv heads,
    16-way) k and v stay whole on each rank, and each rank takes the kv
    head of each of its own q heads (their indices travel as a DTensor
    split like the q heads): a local kernel that saw 1 q head and all 8 kv
    heads would pair them wrongly, without an error.  The gradients of k
    and v then come back as partial sums over "model"."""
    mesh = q.device_mesh
    dp, model = logical_spec(("dp", "model")) or (None, None)
    hq, hkv = q.shape[2], k.shape[2]
    tp = mesh_axis_size(mesh, model)
    heads = model if tp > 1 and hq % tp == 0 else None
    qs = fit_spec((dp, None, heads, None), q.shape, mesh, drop_trivial=True)
    if heads is None or hkv % tp == 0:
        return sharded_call(lambda a, b, c: attention(cfg, a, b, c, causal),
                            (q, k, v), (qs, qs, qs), qs, mesh)
    # the kv head of every q head, split over "model" like the q heads
    kv_of = index_on(
        torch.arange(hq, device=q.to_local().device) // (hq // hkv),
        placements(qs, mesh), 2, mesh)
    kvs = (qs[0], None, None, None)

    def local(a, b, c, own):
        return attention(cfg, a, b.index_select(2, own),
                         c.index_select(2, own), causal)

    return sharded_call(local, (q, k, v, kv_of),
                        (qs, kvs, kvs, tuple(kv_of.placements)), qs, mesh)


def attention(cfg: ArchConfig, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """(B, S, H, d) in and out.  A CUDA tensor goes through the
    flash_attention kernel (seen through a transpose: no copy of q, k, v);
    a CPU or ``meta`` tensor through the plain version, as the reference
    off the TPU.  DTensors (under a mesh) run this on their local shards
    (``_sharded_attention``)."""
    if is_dtensor(q):
        return _sharded_attention(cfg, q, k, v, causal)
    scale = cfg.d_head ** -0.5
    if q.device.type == "cuda":
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, scale=scale)
        return out.transpose(1, 2)
    if q.shape[1] * k.shape[1] > 1 << 22:
        return _attn_chunked(q, k, v, causal, scale, cfg.attn_chunk)
    return _attn_ref(q, k, v, causal, scale)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int, scale: float,
                     layout: str = "heads") -> torch.Tensor:
    """Single-token attention against a (B, S_max, Hkv, d) cache holding
    `length` valid entries.  q: (B, 1, Hq, d).  Plain tensor code, as the
    reference computes it outside any kernel; the dots accumulate in
    float32.  `layout` only changes the sharding under a mesh (the
    reference's ``shard`` calls), so on one card every layout computes the
    same thing."""
    if layout not in ("heads", "dh", "seq"):
        raise ValueError(f"unknown decode cache layout {layout!r}")
    B, Smax, Hkv, d = k_cache.shape
    group = q.shape[2] // Hkv
    qf = split_dim(q.reshape(B, q.shape[2], d), 1, (Hkv, group))
    kf = k_cache
    if layout == "dh":
        qf = shard(qf, ("dp", None, None, "model"))
        kf = shard(kf, ("dp", None, None, "model"))
    elif layout == "seq":
        kf = shard(kf, ("dp", "model", None, None))
    s = torch.einsum("bhgd,bkhd->bhgk", qf.float(), kf.float()) * scale
    if layout == "dh":
        s = shard(s, ("dp", None, None, None))
    elif layout == "seq":
        s = shard(s, ("dp", None, None, "model"))
    valid = torch.arange(Smax, device=q.device)[None, None, None, :] < length
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    vf = v_cache
    if layout == "dh":
        vf = shard(vf, ("dp", None, None, "model"))
    elif layout == "seq":
        vf = shard(vf, ("dp", "model", None, None))
        p = shard(p, ("dp", None, None, "model"))
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                       vf.float())
    if layout == "dh":
        out = shard(out, ("dp", None, None, "model"))
    elif layout == "seq":
        out = shard(out, ("dp", None, None, None))
    return out.reshape(B, 1, q.shape[2], d).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(cfg: ArchConfig, gen: "torch.Generator | None",
             lead: tuple = (), *, device) -> dict:
    dt = DTYPES[cfg.param_dtype]
    d, f = cfg.d_model, cfg.d_ff
    return {
        "norm": init_norm(d, dt, lead, device=device),
        "w_gate": randn((*lead, d, f), gen, device, d ** -0.5, dt),
        "w_up": randn((*lead, d, f), gen, device, d ** -0.5, dt),
        "w_down": randn((*lead, f, d), gen, device, f ** -0.5, dt),
    }


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    h = shard(h, ("dp", None, "model"))
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# blocks (pre-norm residual)
# ---------------------------------------------------------------------------

def attn_block(cfg: ArchConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, h, positions)
    o = attention(cfg, q, k, v, causal=causal)
    return x + merge_dims(o, 2) @ p["wo"]


def mlp_block(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return x + swiglu(p, rms_norm(x, p["norm"], cfg.norm_eps))

"""Mamba2 (SSD) block, the port of ``repro.models.ssm``: in_proj ->
[z | x | B | C | dt], short depthwise conv over (x, B, C), SSD scan, gated
RMSNorm, out_proj.  Decode keeps O(1) state per layer: (h: (B, H, N, P)
float32, conv window: (B, d_conv-1, conv_channels)).

Plain functions over a parameter dict, as ``layers``.  ``mamba_block``
without ``return_state`` (``lm_forward``, ``lm_loss`` and training) goes
through ``ssd_scan``, which dispatches by device: the ssd_scan kernel (K5)
for a CUDA tensor, the sequential recurrence for a CPU tensor; when a
gradient is wanted it is an autograd Function whose backward is K5's
backward kernels on a card and the plain chunked backward on the CPU
(``kernels/ssd_scan/ref.py::ssd_bwd_ref``).  With ``return_state``
(prefill) it runs the plain chunked form ``_ssd_chunked`` on both devices,
and decode the recurrence ``ssd_decode_step``, as the reference does on
every backend.  Under a mesh the scan runs on each rank's local shards
(``_scan``: batch over the dp axes, heads over "model").
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ssd_scan
from ..kernels.ssd_scan.ref import (pad_chunks, ssd_decode_step,
                                    ssd_states_ref)
from .common import DTYPES, ArchConfig
from .layers import init_norm, randn, rms_norm
from .sharding import (fit_spec, is_dtensor, logical_spec, mesh_axis_size,
                       pad, shard, sharded_call, split_dim, whole_dim)

__all__ = ["init_mamba", "mamba_block", "mamba_decode_step",
           "init_mamba_state"]


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.d_head
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return s, d_inner, H, conv_ch


def init_mamba(cfg: ArchConfig, gen: "torch.Generator | None",
               lead: tuple = (), *, device) -> dict:
    """One mamba layer's parameters (with a leading `lead` shape), drawn as
    the reference draws them; ``a_log``, ``dt_bias`` and ``d_skip`` are
    float32 whatever the parameter type."""
    dt = DTYPES[cfg.param_dtype]
    s, d_inner, H, conv_ch = _dims(cfg)
    d = cfg.d_model
    in_dim = 2 * d_inner + 2 * s.n_groups * s.d_state + H
    f32 = torch.float32
    return {
        "pre_norm": init_norm(d, dt, lead, device=device),
        "in_proj": randn((*lead, d, in_dim), gen, device, d ** -0.5, dt),
        "conv_w": randn((*lead, s.d_conv, conv_ch), gen, device, 0.1, dt),
        "conv_b": torch.zeros((*lead, conv_ch), dtype=dt, device=device),
        "a_log": torch.zeros((*lead, H), dtype=f32, device=device),
        "dt_bias": torch.full((*lead, H), -2.0, dtype=f32, device=device),
        "d_skip": torch.ones((*lead, H), dtype=f32, device=device),
        "norm": init_norm(d_inner, dt, lead, device=device),
        "out_proj": randn((*lead, d_inner, d), gen, device,
                          d_inner ** -0.5, dt),
    }


def _split(cfg: ArchConfig, proj: torch.Tensor):
    s, d_inner, H, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    # the parts' boundaries are not the column split's (under a mesh)
    z, xbc, dt_raw = torch.split(whole_dim(proj, -1),
                                 [d_inner, d_inner + 2 * gn, H], dim=-1)
    return z, xbc, dt_raw


def _conv(cfg: ArchConfig, p: dict, xbc: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv along S: xbc (B, S, C), summed tap by tap in
    the reference's order, then SiLU."""
    w = p["conv_w"]                                  # (K, C)
    K = w.shape[0]
    S = xbc.shape[1]
    padded = pad(xbc, (0, 0, K - 1, 0))
    out = sum(padded[:, i:i + S, :] * w[i] for i in range(K))
    return F.silu(out + p["conv_b"])


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: log(1 + e^v) = logaddexp(v, 0) everywhere
    (F.softplus turns into the identity above its threshold)."""
    return torch.logaddexp(v, torch.zeros((), dtype=v.dtype,
                                          device=v.device))


def _ssd_inputs(cfg: ArchConfig, p: dict, xbc: torch.Tensor,
                dt_raw: torch.Tensor):
    s, d_inner, H, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    B_, S = xbc.shape[0], xbc.shape[1]
    x, b, c = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    x = split_dim(x, 2, (H, s.d_head))
    b = split_dim(b, 2, (s.n_groups, s.d_state))
    c = split_dim(c, 2, (s.n_groups, s.d_state))
    dt_v = _softplus(dt_raw.float() + p["dt_bias"])              # (B, S, H)
    a = torch.exp(-torch.exp(p["a_log"]) * dt_v)                 # decay (0, 1]
    x_in = x * dt_v[..., None].to(x.dtype)
    return x, x_in, a, b, c


def mamba_block(cfg: ArchConfig, p: dict, x: torch.Tensor,
                return_state: bool = False):
    """x: (B, S, d) -> out, or (out, {"h", "conv"}) with ``return_state``."""
    s, d_inner, H, conv_ch = _dims(cfg)
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    proj = h @ p["in_proj"]
    z, xbc_raw, dt_raw = _split(cfg, proj)
    xbc = _conv(cfg, p, xbc_raw)
    xs, x_in, a, b, c = _ssd_inputs(cfg, p, xbc, dt_raw)
    xs = shard(xs, ("dp", None, "model", None))
    if return_state:
        y, hfinal = _scan(x_in, a, b, c, s.chunk, True)
    else:
        y = _scan(x_in, a, b, c, s.chunk, False)
    y = y + xs * p["d_skip"][None, None, :, None].to(xs.dtype)
    y = y.reshape(x.shape[0], x.shape[1], d_inner)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = x + y @ p["out_proj"]
    if not return_state:
        return out
    # decode handoff state: final SSD state + last (d_conv - 1) raw conv inputs
    K = s.d_conv
    S = x.shape[1]
    if S >= K - 1:
        conv_state = xbc_raw[:, S - (K - 1):, :]
    else:
        conv_state = F.pad(xbc_raw, (0, 0, K - 1 - S, 0))
    return out, {"h": hfinal, "conv": conv_state}


def _scan(x, a, b, c, chunk: int, return_state: bool):
    """The SSD scan (``ssd_scan``; with `return_state`, or on ``meta``, the
    chunked form, and then with `return_state` its final state too).  On DTensors it runs on each rank's local shards:
    batch over the dp axes, heads over "model" where they divide and the
    groups allow it (one group, or groups that split the axis too)."""
    if return_state:
        fn = lambda x_, a_, b_, c_: _ssd_chunked(x_, a_, b_, c_, chunk)
    elif x.device.type == "meta":
        # shapes only (the dry run): the chunked form, the reference's own
        # path off the TPU; the scan's plain version, a recurrence, would
        # trace S steps a layer
        fn = lambda x_, a_, b_, c_: _ssd_chunked(x_, a_, b_, c_, chunk)[0]
    else:
        fn = lambda x_, a_, b_, c_: ssd_scan(x_, a_, b_, c_, chunk=chunk)
    if not is_dtensor(x):
        return fn(x, a, b, c)
    mesh = x.device_mesh
    dp, model = logical_spec(("dp", "model")) or (None, None)
    H, G = x.shape[2], b.shape[2]
    tp = mesh_axis_size(mesh, model)
    heads = model if tp > 1 and H % tp == 0 and (G == 1 or G % tp == 0) \
        else None
    groups = heads if G > 1 else None
    xs = fit_spec((dp, None, heads, None), x.shape, mesh, drop_trivial=True)
    bs = (xs[0], None, groups, None)
    specs = (xs, xs[:3], bs, bs)
    out = [xs, (xs[0], xs[2], None, None)] if return_state else xs
    return sharded_call(fn, (x, a, b, c), specs, out, mesh)


def _ssd_chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, chunk: int):
    """Chunked SSD in plain tensor ops, the reference's
    ``_ssd_chunked_jnp``: the intra-chunk terms batched over chunks with the
    masked (L x L) decay matrix, then the inter-chunk state recurrence as a
    loop over the chunks (the reference's associative scan computes the
    same prefix).  Returns (y in x's type, final state (B, H, N, P)
    float32)."""
    B, S, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    rep = H // G
    L = min(chunk, S)
    x, a, b, c = pad_chunks(L, x, a, b, c)
    Sp = x.shape[1]
    nC = Sp // L
    la = torch.log(torch.clamp(a, min=1e-37)).float()            # (B, Sp, H)
    # the state entering each chunk, S_c = sum_i exp(tot - cum_i) b_i x_i^T
    # carried as h_c = A_c h_{c-1} + S_c (h before chunk 0 is 0)
    h_in, _, h = ssd_states_ref(x, la, b, L)
    xf = x.reshape(B, nC, L, H, P).float()
    bf = b.repeat_interleave(rep, dim=2).reshape(B, nC, L, H, N).float()
    cf = c.repeat_interleave(rep, dim=2).reshape(B, nC, L, H, N).float()

    cum = torch.cumsum(la.reshape(B, nC, L, H), dim=2)  # (B, nC, L, H)
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()

    # intra-chunk (batched over chunks)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    mask = torch.where(tri[None, None, :, :, None], torch.exp(seg), 0.0)
    scores = torch.einsum("bclhn,bckhn->bclkh", cf, bf) * mask
    y = torch.einsum("bclkh,bckhp->bclhp", scores, xf)
    y = y + torch.exp(cum)[..., None] * torch.einsum("bclhn,bchnp->bclhp",
                                                     cf, h_in)
    y = y.reshape(B, Sp, H, P)[:, :S]
    return y.to(x.dtype), h


# ---------------------------------------------------------------------------
# decode (O(1) state)
# ---------------------------------------------------------------------------

def init_mamba_state(cfg: ArchConfig, batch: int, dtype, *, device) -> dict:
    s, d_inner, H, conv_ch = _dims(cfg)
    return {
        "h": torch.zeros((batch, H, s.d_state, s.d_head), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, conv_ch), dtype=dtype,
                            device=device),
    }


def mamba_decode_step(cfg: ArchConfig, p: dict, state: dict,
                      x: torch.Tensor):
    """x: (B, 1, d) -> (new_state, y (B, 1, d))."""
    s, d_inner, H, conv_ch = _dims(cfg)
    h = rms_norm(x, p["pre_norm"], cfg.norm_eps)
    proj = h @ p["in_proj"]
    z, xbc, dt_raw = _split(cfg, proj)
    window = torch.cat([state["conv"], xbc], dim=1)             # (B, K, C)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, p["conv_w"])
                      + p["conv_b"])[:, None, :]
    new_conv = window[:, 1:, :]
    xs, x_in, a, b, c = _ssd_inputs(cfg, p, conv_out, dt_raw)
    hs, y = ssd_decode_step(state["h"], x_in[:, 0], a[:, 0], b[:, 0],
                            c[:, 0])
    y = y[:, None] + xs * p["d_skip"][None, None, :, None].to(xs.dtype)
    y = y.reshape(x.shape[0], 1, d_inner)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return {"h": hs, "conv": new_conv}, x + y @ p["out_proj"]

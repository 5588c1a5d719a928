"""Mixture-of-Experts layer, the port of ``repro.models.moe``: a top-k
softmax router and a sort-based capacity dispatch (Megablocks-style, in
gather/scatter form: in the reference the token movement is the expert
all-to-all, the fan-in coflow pattern the planner schedules).

Capacity C = ceil(T * top_k / E) * capacity_factor, rounded as Python's
``round`` rounds (half to even) and clamped to [1, T]; a token-expert pair
ranked past C within its expert is dropped and combines as zero (the smoke
configs set the factor high enough that nothing drops).

Plain tensor code on both devices, as the reference computes the dispatch
and the expert products outside any kernel.  The routing is the
reference's to the index: the router runs in float32, the top k take the
lower expert index on a tie (``jax.lax.top_k``'s rule, here a stable
descending sort), a pair's rank within its expert is its position in the
stable sort by expert minus the expert's first position.  The routing,
the dispatch and the combine have no data-dependent shape and read nothing
back, so a card never waits on the host: dropped pairs write into a spare
row of the expert buffer and gather a zero row, and each token sums its k
weighted expert outputs in float32 (a deterministic sum, not an atomic
scatter).

The reference's ``shard`` annotations are kept at its places (no-ops
outside a mesh).  ``moe_ffn_shard_map`` is the reference's per-data-shard
routing: under a mesh each rank routes its own tokens (``local_map`` over
the dp axes) and runs the experts it holds; without one it is ``moe_ffn``,
as the reference's is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import DTYPES, ArchConfig
from .sharding import (fit_spec, index_on, is_dtensor, logical_spec,
                       placements, shard, sharded_call)
from .layers import init_norm, randn, rms_norm

__all__ = ["init_moe", "moe_block", "moe_ffn", "moe_ffn_shard_map",
           "moe_route", "capacity"]


def init_moe(cfg: ArchConfig, gen: "torch.Generator | None",
             lead: tuple = (), *, device) -> dict:
    """One MoE layer's parameters (with a leading `lead` shape), drawn as
    the reference draws them; ``router`` is float32 whatever the parameter
    type."""
    dt = DTYPES[cfg.param_dtype]
    spec = cfg.moe
    d, f, e = cfg.d_model, spec.d_ff_expert, spec.n_experts
    return {
        "norm": init_norm(d, dt, lead, device=device),
        "router": randn((*lead, d, e), gen, device, d ** -0.5,
                        torch.float32),
        "w_gate": randn((*lead, e, d, f), gen, device, d ** -0.5, dt),
        "w_up": randn((*lead, e, d, f), gen, device, d ** -0.5, dt),
        "w_down": randn((*lead, e, f, d), gen, device, f ** -0.5, dt),
    }


def capacity(T: int, k: int, E: int, capacity_factor: float) -> int:
    """The reference's capacity, line for line: a single expert receives at
    most T tokens (each token routes to k distinct experts), which also
    makes small-T decode steps drop-free."""
    return int(min(T, max(1, round(-(-T * k // E) * capacity_factor))))


def _count(e: torch.Tensor, E: int) -> torch.Tensor:
    """Pairs per expert, (E,) int64: a scatter-add, which (unlike
    ``bincount`` on a card) reads no size back to the host."""
    return torch.zeros(E, dtype=torch.long, device=e.device).scatter_add_(
        0, e, torch.ones_like(e))


def moe_route(cfg: ArchConfig, router: torch.Tensor,
              xt: torch.Tensor) -> dict:
    """Routing of T tokens xt: (T, d).  Returns, per token, ``idx`` and
    ``gate`` (T, k), the experts and their weights; per pair of the stable
    sort by expert, ``tok`` (the token), ``slot`` (expert * C + rank) and
    ``keep`` (rank < C); per original pair (token-major), ``pair_slot``
    (the slot, or E * C where the pair is dropped); ``aux`` (the Switch
    load-balancing loss, float32) and ``C``."""
    spec = cfg.moe
    T = xt.shape[0]
    E, k = spec.n_experts, spec.top_k
    probs = torch.softmax(xt.float() @ router, dim=-1)          # (T, E)
    # top k with jax.lax.top_k's tie rule: the lower index first
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    if spec.router_norm_topk:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # load-balancing aux loss (Switch-style)
    flat_e = idx.reshape(-1)                                    # (T*k,)
    counts = _count(flat_e, E)
    me = probs.mean(dim=0)
    ce = counts.float() / (T * k)
    aux = E * torch.sum(me * ce)

    C = capacity(T, k, E, spec.capacity_factor)
    # sort token-expert pairs by expert; rank within expert = position in
    # the sorted run minus the expert's first position
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    first = torch.cumsum(counts, 0) - counts
    rank = torch.arange(se.numel(), device=xt.device) - first[se]
    keep = rank < C
    slot = se * C + rank
    pair_slot = torch.empty_like(slot)
    pair_slot[order] = torch.where(keep, slot, E * C)
    return {"idx": idx, "gate": gate, "tok": order // k, "slot": slot,
            "keep": keep, "pair_slot": pair_slot, "aux": aux, "C": C}


def moe_ffn(cfg: ArchConfig, p: dict, x: torch.Tensor,
            experts: torch.Tensor | None = None):
    """x: (B, S, d) -> (y, aux_loss).  With `experts` (the ids of the
    experts whose weights `p` holds, in order) only those experts run, and
    y is their share of the output (``moe_ffn_shard_map``'s local part)."""
    spec = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = spec.n_experts, spec.top_k
    xt = x.reshape(T, d)
    r = moe_route(cfg, p["router"], xt)
    C = r["C"]

    # scatter tokens into (E*C, d) buffers; a dropped pair writes the
    # spare row E*C, which no expert reads
    xbuf = x.new_zeros((E * C + 1, d))
    xbuf.index_copy_(0, torch.where(r["keep"], r["slot"], E * C),
                     xt[r["tok"]])
    xbuf = shard(xbuf[:E * C].view(E, C, d), ("model", None, None))
    if experts is not None:
        xbuf = xbuf.index_select(0, experts)

    h = torch.bmm(xbuf, p["w_gate"])
    u = torch.bmm(xbuf, p["w_up"])
    y = torch.bmm(F.silu(h) * u, p["w_down"])
    if experts is not None:
        y = y.new_zeros((E, C, d)).index_copy(0, experts, y)
    y = y.reshape(E * C, d)

    # combine back to tokens with gate weights, accumulated in float32; a
    # dropped pair gathers the zero row E*C
    y = torch.cat([y, y.new_zeros((1, d))])
    contrib = y[r["pair_slot"]].float() * r["gate"].reshape(-1, 1)
    out = contrib.view(T, k, d).sum(dim=1)
    return shard(out.to(x.dtype).reshape(B, S, d), ("dp", None, None)), \
        r["aux"]


def moe_ffn_shard_map(cfg: ArchConfig, p: dict, x: torch.Tensor):
    """The reference's per-data-shard routing (its ``jax.shard_map``, manual
    over the dp axes).  Under a mesh each rank routes the tokens of its own
    data shard (every "model" rank of that shard the same ones) and runs
    the experts whose weights it holds: their ids travel as a DTensor
    placed like the weights' expert dim, so a rank reads its own without
    knowing its coordinate.  Each rank's output is its experts' share, a
    ``Partial`` sum over "model" (EP on experts, or TP on the ffn dim with
    ``moe_ffn_tp``); ``aux`` comes back per data shard and is averaged
    outside.  The reference's GSPMD keeps "model" automatic inside the
    shard_map and moves the (E, C, d) buffer by all-to-all; here the
    combine is an all-reduce of the tokens' outputs over "model".  Without
    a mesh it is ``moe_ffn``."""
    from torch.distributed.tensor import Partial

    if not is_dtensor(x):
        return moe_ffn(cfg, p, x)
    mesh = x.device_mesh
    dp = (logical_spec(("dp",)) or (None,))[0]
    xspec = fit_spec((dp, None, None), x.shape, mesh, drop_trivial=True)
    wg = p["w_gate"]
    w_pl = [tuple(p[n].placements) for n in ("w_gate", "w_up", "w_down")]
    ids = index_on(torch.arange(cfg.moe.n_experts,
                                device=wg.to_local().device), w_pl[0], 0,
                   mesh)
    y_pl = list(placements(xspec, mesh))
    aux_pl = list(placements((xspec[0],), mesh))
    parts = 1
    for i in range(mesh.ndim):
        if any(pl[i].is_shard() for pl in w_pl):
            y_pl[i] = aux_pl[i] = Partial()
            parts *= mesh.shape[i]

    def local(xl, router, g, u, dn, own):
        lp = {"router": router, "w_gate": g, "w_up": u, "w_down": dn}
        y, aux = moe_ffn(cfg, lp, xl, experts=own)
        # each "model" rank's share of the (replicated) aux loss, so that
        # its gradient, like the outputs', sums over the ranks
        return y, (aux / parts)[None]

    y, aux = sharded_call(
        local, (x, p["router"], wg, p["w_up"], p["w_down"], ids),
        (xspec, (), *w_pl, tuple(ids.placements)),
        [tuple(y_pl), tuple(aux_pl)], mesh)
    return y, aux.mean()


def moe_block(cfg: ArchConfig, p: dict, x: torch.Tensor):
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    if cfg.moe.impl == "shard_map":
        y, aux = moe_ffn_shard_map(cfg, p, h)
    else:
        y, aux = moe_ffn(cfg, p, h)
    return x + y, aux

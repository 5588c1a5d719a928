"""AdamW with a cosine schedule, linear warmup and global-norm clipping, the
port of ``repro.train.optim``: float32 moments whatever the parameters'
type.

The update is the reference's, operation for operation: the global norm of
the gradients in float32, the clip scale, bias corrections ``1 - b**step``
in float32, and ``delta = mh / (sqrt(vh) + eps) + wd * p`` in float32, the
parameter cast back to its own type.  There is no float32 master copy: a
bfloat16 parameter stays bfloat16.  ``torch.optim.AdamW`` is not used: it
applies the decay in another order and keeps other state.

Parameters, gradients and moments are nested dicts of tensors (the model's
parameter trees, walked in sorted-key order as ``jax.tree`` walks them);
the update writes into the parameters and moments it is given.  One code
path serves one card and a mesh: the update is elementwise arithmetic on
each rank's local shards, at the moments' placements (``_update_leaf``),
and the global norm sums each leaf's local squares over the ranks that
hold its other shards (``_global_norm``).  A plain tensor is its own local
shard, so on one card both are the unsharded arithmetic.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..models.lm import tree_leaves, tree_map
from ..models.sharding import is_dtensor

__all__ = ["OptConfig", "adamw_init", "adamw_update", "lr_at"]


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at `step` (an int or a tensor), float32: linear
    warmup from 0, then a cosine from ``lr`` down to ``lr * min_lr_ratio``
    at ``total_steps``, held there after."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5
                    * (1 + torch.cos(math.pi * t)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """float32 zeros shaped like `p`, placed like it when it is a
    DTensor."""
    if is_dtensor(p):
        from torch.distributed.tensor import zeros

        return zeros(p.shape, dtype=torch.float32, device_mesh=p.device_mesh,
                     placements=p.placements)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params: dict) -> dict:
    """Zero float32 moments shaped like `params`, and step 0 (int32)."""
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros_f32, params),
            "v": tree_map(zeros_f32, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if is_dtensor(t) else t


def _global_norm(leaves: list) -> torch.Tensor:
    """sqrt of the sum over `leaves` of sum(g^2), float32, a plain tensor,
    leaves in the given (sorted-key) order.  Each leaf's sum of squares is
    over its local shard (the whole of a plain tensor), summed over the
    mesh dims that shard it by one all-reduce a set of such dims (the
    leaves' sums stacked), then added up in leaf order.  On a mesh of one
    rank each sum is the whole leaf's, so the norm is the unsharded one to
    the bit."""
    sq = [torch.sum(torch.square(_local(g).float())) for g in leaves]
    groups: dict = {}
    for i, g in enumerate(leaves):
        if is_dtensor(g):
            if any(pl.is_partial() for pl in g.placements):
                raise ValueError("_global_norm takes no Partial gradient")
            key = tuple(pl.is_shard() for pl in g.placements)
            if any(key):
                groups.setdefault((g.device_mesh, key), []).append(i)
    for (mesh, key), idx in groups.items():
        from torch.distributed.tensor import DTensor, Partial, Replicate

        part = DTensor.from_local(
            torch.stack([sq[i] for i in idx]), mesh,
            [Partial() if k else Replicate() for k in key], run_check=False)
        summed = part.redistribute(mesh, [Replicate()] * mesh.ndim)
        for j, i in enumerate(summed.to_local()):
            sq[idx[j]] = i
    total = sq[0]
    for t in sq[1:]:
        total = total + t
    return torch.sqrt(total)


SLICE = 1 << 26             # elements of a leaf that AdamW updates at once


def _slices(t: torch.Tensor):
    """Leading-dim ranges of `t` holding at most SLICE elements each (one
    row at least; the whole of a 0-d tensor)."""
    if t.dim() == 0:
        yield ...
        return
    rows = max(1, SLICE // max(1, t[0].numel()))
    for i in range(0, t.shape[0], rows):
        yield slice(i, i + rows)


@torch.no_grad()
def adamw_update(params: dict, grads: dict, opt_state: dict,
                 cfg: OptConfig):
    """One AdamW step -> (params, opt state, {"grad_norm", "lr"}).  Writes
    the new parameters and moments into the given tensors (and returns the
    same dicts) with a new step tensor: a functional update, as the
    reference's, would hold the old and the new float32 moments at once
    (16 GB more at qwen3-1.7b).  A leaf is updated in slices of its leading
    dim of at most SLICE elements, so the float32 temporaries stay near 2 GB
    whatever its size (mamba2-2.7b's stacked in_proj, 1.73 G elements, took
    seven 6.9 GB temporaries at once and ran the card out of memory); the
    update is elementwise, so the slices change no bit.  The values are
    the reference's."""
    step = opt_state["step"] + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                    device=stepf.device), stepf)
    c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                    device=stepf.device), stepf)
    leaves = list(zip(tree_leaves(params), tree_leaves(grads),
                      tree_leaves(opt_state["m"]),
                      tree_leaves(opt_state["v"])))
    for p, g, m, v in leaves:
        if not (p.shape == g.shape == m.shape == v.shape):
            raise ValueError(f"adamw_update: shapes disagree: param "
                             f"{tuple(p.shape)}, grad {tuple(g.shape)}, "
                             f"moments {tuple(m.shape)}, {tuple(v.shape)}")
    leaves = [(p, _at(g, m), m, v) for p, g, m, v in leaves]
    gnorm = _global_norm([g for _, g, _, _ in leaves])
    scale = torch.minimum(torch.ones((), device=gnorm.device),
                          cfg.grad_clip / torch.clamp(gnorm, min=1e-12))
    for p, g, m, v in leaves:
        _update_leaf(p, g, m, v, scale, lr, c1, c2, cfg)
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, {"grad_norm": gnorm, "lr": lr}


def _at(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The DTensor `g` at `like`'s placements (itself when they agree)."""
    if is_dtensor(g) and tuple(g.placements) != tuple(like.placements):
        return g.redistribute(g.device_mesh, like.placements)
    return g


def _update_leaf(p, g, m, v, scale, lr, c1, c2, cfg: OptConfig) -> None:
    """`adamw_update`'s elementwise update of one leaf on each rank's local
    shards, at the moments' placements, in SLICE-element slices.  A
    DTensor parameter is sliced to those placements (a local chunk where it
    is replicated, the ZeRO case) and gathered back to its own after; a
    plain tensor is updated in place."""
    b1, b2 = cfg.beta1, cfg.beta2
    pm = _at(p, m)
    pl, gl, ml, vl = _local(pm), _local(g), _local(m), _local(v)
    for sl in _slices(pl):
        gs = gl[sl].float() * scale
        m_new = b1 * ml[sl] + (1 - b1) * gs
        v_new = b2 * vl[sl] + (1 - b2) * gs * gs
        mh = m_new / c1
        vh = v_new / c2
        pf = pl[sl].float()
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
        pl[sl].copy_((pf - lr * delta).to(pl.dtype))
        ml[sl].copy_(m_new)
        vl[sl].copy_(v_new)
    if pm is not p:
        p.to_local().copy_(pm.redistribute(p.device_mesh,
                                           p.placements).to_local())

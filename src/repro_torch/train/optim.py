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
the update writes into the parameters and moments it is given.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..models.lm import tree_leaves, tree_map

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


def adamw_init(params: dict) -> dict:
    """Zero float32 moments shaped like `params`, and step 0 (int32)."""
    def zeros(p: torch.Tensor) -> torch.Tensor:
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(g^2), in float32, leaves in the
    reference's (sorted-key) order."""
    total = None
    for g in tree_leaves(grads):
        sq = torch.sum(torch.square(g.float()))
        total = sq if total is None else total + sq
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
    gnorm = _global_norm(grads)
    scale = torch.minimum(torch.ones((), device=gnorm.device),
                          cfg.grad_clip / torch.clamp(gnorm, min=1e-12))
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                    device=stepf.device), stepf)
    c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                    device=stepf.device), stepf)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"])):
        if not (p.shape == g.shape == m.shape == v.shape):
            raise ValueError(f"adamw_update: shapes disagree: param "
                             f"{tuple(p.shape)}, grad {tuple(g.shape)}, "
                             f"moments {tuple(m.shape)}, {tuple(v.shape)}")
        for sl in _slices(p):
            gs = g[sl].float() * scale
            m_new = b1 * m[sl] + (1 - b1) * gs
            v_new = b2 * v[sl] + (1 - b2) * gs * gs
            mh = m_new / c1
            vh = v_new / c2
            pf = p[sl].float()
            delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
            p[sl].copy_((pf - lr * delta).to(p.dtype))
            m[sl].copy_(m_new)
            v[sl].copy_(v_new)
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, {"grad_norm": gnorm, "lr": lr}

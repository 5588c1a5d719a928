"""Train step builder, the port of ``repro.train.step``: the family's loss,
microbatch gradient accumulation, the planner's gradient-bucket order and
the AdamW update.

The bucket-order hook: gradients are grouped into buckets of leaf paths
('/'-joined keys of the parameter tree); ``bucket_order`` (from
``repro_torch.dist.planner``, the G-DM permutation over the step's
collectives) is the order in which the buckets' all-reduces are issued.
The reference pins that launch order in its compiled step with
``jax.lax.optimization_barrier``.  Under a mesh (DTensor parameters) the
port redistributes each bucket's gradients, ``Partial`` sums over the data
axes, to their moments' placements bucket by bucket in the planned order,
so the eager call order is the launch order of the gradient all-reduces
and reduce-scatters (``_apply_bucket_order``).  On one card there is no
collective and the gradients come back as they are.  Neither changes a
value.

On a card every attention of the loss runs the flash_attention kernel (K4)
forward and backward, and every mamba layer the ssd_scan kernel (K5)
forward and backward (``kernels/ssd_scan``: the chunk state gradients,
the reverse pass, the chunk gradients and the group sum); on the CPU the
plain versions, K5's backward ``ssd_bwd_ref``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..models import (ArchConfig, encdec_loss, init_encdec, init_lm,
                      init_vlm, lm_loss, vlm_loss)
from ..models.lm import tree_leaves
from ..models.sharding import is_dtensor
from .optim import OptConfig, adamw_init, adamw_update, zeros_f32

__all__ = ["TrainState", "init_params", "init_train_state",
           "build_train_step", "loss_for", "leaf_paths", "path_str"]


@dataclass
class TrainState:
    """params (the model's tree), opt ({"m", "v", "step"}, adamw_init) and
    step (int32 scalar): the reference's TrainState, which flattens as
    (params, opt, step)."""
    params: Any
    opt: Any
    step: torch.Tensor


def init_params(cfg: ArchConfig, gen: "torch.Generator | None",
                device: "torch.device | str | None" = None) -> dict:
    if cfg.family == "encdec":
        return init_encdec(cfg, gen, device=device)
    if cfg.family == "vlm":
        return init_vlm(cfg, gen, device=device)
    return init_lm(cfg, gen, device=device)


def init_train_state(cfg: ArchConfig, gen: "torch.Generator | None",
                     device: "torch.device | str | None" = None
                     ) -> TrainState:
    """Parameters drawn from `gen` (on its device unless `device` says
    otherwise; ``device="meta"`` without a generator gives the shapes),
    zero moments and step 0."""
    params = init_params(cfg, gen, device)
    dev = tree_leaves(params)[0].device
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def loss_for(cfg: ArchConfig) -> Callable:
    """Batch dict -> scalar loss, per family.  Batch layouts
    (``data.make_batch_specs``): lm {tokens, labels}; vlm {patches, tokens,
    labels}; encdec {frames, tokens, labels}."""
    if cfg.family == "encdec":
        return lambda p, b: encdec_loss(cfg, p, b["frames"], b["tokens"],
                                        b["labels"])
    if cfg.family == "vlm":
        return lambda p, b: vlm_loss(cfg, p, b["patches"], b["tokens"],
                                     b["labels"])
    return lambda p, b: lm_loss(cfg, p, b["tokens"], b["labels"])


def path_str(keys) -> str:
    """'/'-joined tree path ('stack/l0/attn/wq'), the bucket-order key: the
    port's copy of the reference's ``dist.partition._path_str``."""
    return "/".join(str(k) for k in keys)


def leaf_paths(tree, prefix: tuple = ()) -> list[str]:
    """The paths of a nested dict's leaves, in the order ``tree_leaves``
    gives them (sorted keys, as ``jax.tree_util`` flattens a dict)."""
    if isinstance(tree, dict):
        return [p for key in sorted(tree)
                for p in leaf_paths(tree[key], prefix + (key,))]
    return [path_str(prefix)]


def tree_unflatten(like, leaves: list):
    """A nested dict shaped like `like` whose leaves, in ``tree_leaves``
    order, are `leaves`."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {key: build(t[key]) for key in sorted(t)}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _apply_bucket_order(grads: dict, order: list[list[str]] | None,
                        like: dict | None = None) -> dict:
    """Walk the gradient buckets in the planner's order: `order` is a list
    of buckets, each a list of '/'-joined leaf paths (paths not in the tree
    are skipped, as the reference skips them; unlisted leaves keep no
    order).  DTensor gradients are redistributed here, bucket by bucket,
    to the placements of their leaf in `like` (the moments: the
    parameters' placements, or the ZeRO specs), ``Replicate`` for a
    ``Partial`` sum without `like`; the leaves no bucket lists follow in
    the tree's order.  Each redistribution issues that leaf's all-reduce
    or reduce-scatter, so the call order is the launch order.  One card
    has no collective, so its gradients come back unchanged."""
    leaves = tree_leaves(grads)
    if any(is_dtensor(g) for g in leaves):
        from torch.distributed.tensor import Replicate

        paths = leaf_paths(grads)
        flat = dict(zip(paths, leaves))
        target = dict(zip(paths, tree_leaves(like))) if like else {}
        walk = [p for bucket in (order or []) for p in bucket if p in flat]
        for p in dict.fromkeys(walk + paths):
            g, t = flat[p], target.get(p)
            want = tuple(t.placements) if t is not None else tuple(
                Replicate() if pl.is_partial() else pl for pl in g.placements)
            if tuple(g.placements) != want:
                flat[p] = g.redistribute(g.device_mesh, want)
        return tree_unflatten(grads, [flat[p] for p in paths])
    if order:
        known = set(leaf_paths(grads))
        for bucket in order:
            issued = [p for p in bucket if p in known]  # noqa: F841
            # a data-parallel run all-reduces the `issued` leaves here
    return grads


def _micro(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch `i` of `n` of a batch leaf: rows [i B/n, (i+1) B/n).  A
    DTensor split over the batch gives each rank's i-th slice of its own
    rows instead (slicing the global rows would gather them): the same
    rows overall, summed in the same mean, in another grouping."""
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor

        loc = x.to_local()
        m = loc.shape[0] // n
        return DTensor.from_local(loc[i * m:(i + 1) * m], x.device_mesh,
                                  x.placements, run_check=False)
    m = x.shape[0] // n
    return x[i * m:(i + 1) * m]


def _value_and_grad(loss_fn: Callable, params: dict, batch: dict):
    """(loss detached, grads shaped like params, each in its parameter's
    type)."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    loss = loss_fn(tree_unflatten(params, live), batch)
    grads = torch.autograd.grad(loss, live)
    return loss.detach(), tree_unflatten(params, list(grads))


def build_train_step(
    cfg: ArchConfig,
    opt_cfg: OptConfig,
    micro_steps: int = 1,
    bucket_order: list[list[str]] | None = None,
    grad_compression: bool = False,
) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics), metrics
    {"loss", "grad_norm", "lr", "step"}.  Batch leaves have the global
    batch as their leading dim; ``micro_steps > 1`` splits it into that
    many chunks whose gradients accumulate in float32 and are scaled by
    1/micro_steps, as the reference's scan does.  The step writes the new
    parameters and moments into the state's tensors (``adamw_update``)."""
    loss_fn = loss_for(cfg)

    def compute_grads(params, batch):
        if micro_steps == 1:
            return _value_and_grad(loss_fn, params, batch)
        B = next(iter(batch.values())).shape[0]
        if B % micro_steps:
            raise ValueError(f"global batch {B} is not a multiple of "
                             f"micro_steps {micro_steps}")
        n = B // micro_steps
        dev = tree_leaves(params)[0].device
        loss_acc = torch.zeros((), dtype=torch.float32, device=dev)
        g_acc = [zeros_f32(p) for p in tree_leaves(params)]
        for i in range(micro_steps):
            mb = {key: _micro(x, i, micro_steps) for key, x in batch.items()}
            loss, g = _value_and_grad(loss_fn, params, mb)
            g_acc = [a + b.to(a.dtype) for a, b in zip(g_acc, tree_leaves(g))]
            loss_acc = loss_acc + loss
        inv = 1.0 / micro_steps
        return loss_acc * inv, tree_unflatten(params,
                                              [g * inv for g in g_acc])

    def train_step(state: TrainState, batch: dict):
        loss, grads = compute_grads(state.params, batch)
        if grad_compression:
            from ..dist.compression import compress_decompress
            grads = compress_decompress(grads)
        grads = _apply_bucket_order(grads, bucket_order, state.opt["m"])
        params, opt, stats = adamw_update(state.params, grads, state.opt,
                                          opt_cfg)
        new_state = TrainState(params=params, opt=opt, step=state.step + 1)
        return new_state, {"loss": loss, **stats, "step": state.step + 1}

    return train_step

"""Parameter / batch partition rules, the port of ``repro.dist.partition``
on ``torch.distributed.tensor``.

Name-based rule table over the parameter tree's '/'-joined leaf paths
(``train.step.leaf_paths``; every stacked leaf has a leading period dim
``nP``).  A spec is plain data, one entry per dim (None, a mesh axis name
or a tuple of names), the reference's ``PartitionSpec`` as a tuple:

  embed (V, D)            -> ("model", None)      vocab TP
  unembed (D, V)          -> (None, "model")      vocab TP
  wq/wk/wv/w_gate/w_up    -> (None, None, "model")   column split
  wo/w_down (3D)          -> (None, "model", None)   row split
  moe w_gate/w_up/w_down  -> (None, "model", None, None)  EP on experts
    (moe_ffn_tp=True instead splits the ffn dim)
  ssm in_proj / out_proj  -> column / row split
  norm scales, biases, router, ssm scalars -> replicated (())

``zero_pspecs`` upgrades the param specs for ZeRO optimizer state: each
leaf's first still-unsharded, dp-divisible dim is also sharded over the
data axes.  ``shardings`` turns specs into DTensor placements (entries
that do not divide their dim dropped, as the reference's dry run
sanitises them) and ``distribute`` places a tree of tensors by them, what
``jax.device_put(params, shardings)`` does in the reference.
"""
from __future__ import annotations

from ..models.lm import tree_map
from ..models.sharding import fit_spec, placements
from ..train.step import leaf_paths, tree_unflatten
from ..models.lm import tree_leaves

__all__ = ["param_pspecs", "zero_pspecs", "shardings", "batch_pspecs",
           "dp_axes", "distribute", "state_pspecs", "distribute_state",
           "leaf_rule"]

_DP_AXIS_ORDER = ("pod", "data")


def dp_axes(mesh) -> tuple[str, ...]:
    """Data-parallel mesh axes, outermost first."""
    names = tuple(mesh.mesh_dim_names or ())
    return tuple(a for a in _DP_AXIS_ORDER if a in names)


def _size(mesh, axes: tuple) -> int:
    names = tuple(mesh.mesh_dim_names)
    n = 1
    for a in axes:
        n *= mesh.shape[names.index(a)]
    return n


def leaf_rule(pathstr: str, name: str, nd: int, moe_ffn_tp: bool) -> tuple:
    if name == "embed":
        return ("model", None)
    if name == "unembed":
        return (None, "model")
    if name == "scale" or name == "router" or "norm" in pathstr:
        return ()
    if "moe" in pathstr and name in ("w_gate", "w_up", "w_down") and nd == 4:
        if moe_ffn_tp:  # TP on the ffn dim instead of EP on experts
            if name == "w_down":
                return (None, None, "model", None)
            return (None, None, None, "model")
        return (None, "model", None, None)
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "in_proj") and nd == 3:
        return (None, None, "model")
    if name in ("wo", "w_down", "out_proj") and nd == 3:
        return (None, "model", None)
    return (None,) * nd


def param_pspecs(params: dict, moe_ffn_tp: bool = False) -> dict:
    """Spec tree mirroring `params` (meta or real tensors)."""
    specs = []
    for path, leaf in zip(leaf_paths(params), tree_leaves(params)):
        name = path.rsplit("/", 1)[-1]
        specs.append(leaf_rule(path, name, leaf.dim(), moe_ffn_tp))
    return tree_unflatten(params, specs)


def zero_pspecs(params: dict, mesh) -> dict:
    """ZeRO: param specs + data-axis sharding of the first free divisible
    dim of each leaf (optimizer moments live fully sharded)."""
    dp = dp_axes(mesh)
    dp_total = _size(mesh, dp) if dp else 1
    dp_entry = dp if len(dp) > 1 else (dp[0] if dp else None)
    out = []
    for leaf, spec in zip(tree_leaves(params),
                          tree_leaves(param_pspecs(params))):
        nd = leaf.dim()
        full = tuple(spec) + (None,) * (nd - len(spec))
        upgraded = list(full)
        if dp_entry is not None:
            for i, ax in enumerate(full):
                if ax is None and leaf.shape[i] % max(dp_total, 1) == 0 \
                        and leaf.shape[i] > 0:
                    upgraded[i] = dp_entry
                    break
        out.append(tuple(upgraded))
    return tree_unflatten(params, out)


def batch_pspecs(batch: dict, mesh) -> dict:
    """Batch tree: leading dim sharded over the dp axes, rest replicated."""
    dp = dp_axes(mesh)
    entry = dp if len(dp) > 1 else (dp[0] if dp else None)
    return tree_map(lambda _: (entry,), batch)


def shardings(specs: dict, like: dict, mesh) -> dict:
    """Spec tree -> placements tree on `mesh`, each spec fitted to its
    leaf in `like` (an entry whose shards do not divide its dim replicates
    that dim)."""
    return tree_unflatten(like, [
        placements(fit_spec(s, t.shape, mesh), mesh)
        for s, t in zip(tree_leaves(specs), tree_leaves(like))])


def distribute(tree, specs, mesh):
    """`tree`'s tensors as DTensors on `mesh` with the placements of
    `specs` (``distribute_tensor``: each rank keeps its shard; a leaf that
    needs a gradient keeps needing one).  A leaf whose spec is None, or
    that is not a tensor (a Python int), stays as it is."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    out = []
    for t, s in zip(tree_leaves(tree), tree_leaves(specs)):
        if s is None or not isinstance(t, torch.Tensor):
            out.append(t)
            continue
        pl = placements(fit_spec(s, t.shape, mesh), mesh)
        d = distribute_tensor(t.detach(), mesh, list(pl))
        out.append(d.requires_grad_(t.requires_grad))
    return tree_unflatten(tree, out) if isinstance(tree, dict) else out[0]


def state_pspecs(params: dict, mesh, *, moe_ffn_tp: bool = False,
                 zero: bool = False) -> dict:
    """Spec tree of a train state ``{"params", "opt": {"m", "v", "step"},
    "step"}``: the parameters by ``param_pspecs``, the moments by the same
    specs or, with `zero`, by ``zero_pspecs``; the step counters None (they
    stay plain tensors)."""
    ps = param_pspecs(params, moe_ffn_tp=moe_ffn_tp)
    ms = zero_pspecs(params, mesh) if zero else ps
    return {"params": ps, "opt": {"m": ms, "v": ms, "step": None},
            "step": None}


def distribute_state(state, mesh):
    """A ``TrainState`` on `mesh` by ``state_pspecs``' default specs."""
    from ..train.step import TrainState

    specs = state_pspecs(state.params, mesh)
    opt = dict(state.opt, m=distribute(state.opt["m"], specs["opt"]["m"],
                                       mesh),
               v=distribute(state.opt["v"], specs["opt"]["v"], mesh))
    return TrainState(params=distribute(state.params, specs["params"], mesh),
                      opt=opt, step=state.step)

"""Logical sharding annotations for model code, the port of
``repro.models.sharding`` on ``torch.distributed.tensor`` (DTensor).

Models call ``shard(x, ("dp", None, "model"))`` with *logical* axis names.
Outside a mesh context, or on a tensor that is not a DTensor, this returns
``x`` itself.  Inside one it redistributes the DTensor to the placements
the active rules give, as the reference's ``with_sharding_constraint``
does.  The rules map logical names to mesh axes:

    dp    -> ("pod", "data") or ("data",)   batch / data parallel
    model -> ("model",)                      tensor / expert parallel
    sp    -> ("data",)                       sequence parallel (long decode)

A spec is plain data, one entry per tensor dim: ``None``, a mesh axis name
or a tuple of axis names (the reference's ``PartitionSpec`` as a tuple).
``placements(spec, mesh)`` turns it into DTensor placements: an entry
``("pod", "data")`` on dim 0 is ``Shard(0)`` on both mesh dims, pod major,
as in GSPMD.

Inside ``mesh_context`` plain tensors that meet a DTensor (an ``arange``, a
mask, a scalar) count as replicated (DTensor's ``implicit_replication``).
``sharded_call`` runs a kernel on each rank's local shards
(``local_map``), the port's ``shard_map``.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

__all__ = ["mesh_context", "current_mesh", "logical_spec",
           "placements", "fit_spec", "shard", "is_dtensor", "sharded_call",
           "mesh_axis_size", "split_dim", "reduce_partial",
           "sum_partial_grad", "merge_dims", "pad", "whole_dim", "index_on",
           "DEFAULT_RULES"]

_ctx = threading.local()

DEFAULT_RULES = {
    "dp": ("data",),
    "model": ("model",),
    "sp": ("data",),
}


def _axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


@contextmanager
def mesh_context(mesh, rules: dict | None = None):
    """Make `mesh` (a ``DeviceMesh`` with named dims) and the logical-axis
    `rules` current; rules naming axes the mesh lacks are trimmed."""
    from torch.distributed.tensor.experimental import implicit_replication

    rules = dict(rules or {})
    for k, v in DEFAULT_RULES.items():
        rules.setdefault(k, v)
    names = _axis_names(mesh)
    rules = {k: tuple(a for a in v if a in names) for k, v in rules.items()}
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, rules)
    try:
        with implicit_replication():
            yield
    finally:
        _ctx.state = prev


def current_mesh():
    st = getattr(_ctx, "state", None)
    return st[0] if st else None


def _entry(mapped: tuple):
    return mapped if len(mapped) > 1 else (mapped[0] if mapped else None)


def logical_spec(axes: tuple) -> tuple | None:
    """The spec the active rules give `axes` (None outside a context), with
    no divisibility check: the reference's ``logical_spec`` as a tuple."""
    st = getattr(_ctx, "state", None)
    if st is None:
        return None
    _, rules = st
    return tuple(None if a is None else _entry(rules.get(a, ()))
                 for a in axes)


def mesh_axis_size(mesh, entry) -> int:
    """The number of shards a spec entry makes on `mesh` (1 for None)."""
    if entry is None:
        return 1
    names = _axis_names(mesh)
    size = 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        size *= mesh.shape[names.index(a)]
    return size


def fit_spec(spec: tuple, shape, mesh, *, drop_trivial: bool = False
             ) -> tuple:
    """`spec` padded to len(shape) with None, each entry dropped whose
    shards do not divide its dim (the reference's ``_sanitize_shardings``);
    with ``drop_trivial`` also each that makes one shard, and each past the
    tensor's rank (the reference's ``shard``)."""
    spec = tuple(spec)[:len(shape)] + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in enumerate(spec):
        size = mesh_axis_size(mesh, entry)
        if entry is None or shape[dim] % size != 0 \
                or (drop_trivial and size <= 1):
            out.append(None)
        else:
            out.append(entry)
    return tuple(out)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of a plain spec on `mesh`: ``Shard(dim)`` on every
    mesh dim the entry of tensor dim `dim` names, ``Replicate()`` on the
    rest.  A tuple entry shards over its axes major to minor in the mesh's
    order (pod before data)."""
    from torch.distributed.tensor import Replicate, Shard

    names = _axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for a in axes:
            i = names.index(a)
            if not out[i].is_replicate():
                raise ValueError(f"mesh axis {a!r} shards two dims in "
                                 f"{spec!r}")
            out[i] = Shard(dim)
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    """Redistribute the DTensor `x` to the logical sharding `axes`; `x`
    itself outside a mesh context or when `x` is not a DTensor.  An axis
    that does not divide its dim, or makes one shard, is dropped (GSPMD
    would pad or rematerialise: 8 kv heads cannot split a 16-way model
    axis)."""
    st = getattr(_ctx, "state", None)
    if st is None or not is_dtensor(x):
        return x
    mesh, rules = st
    spec = tuple(None if a is None else _entry(rules.get(a, ()))
                 for a in axes)
    want = placements(fit_spec(spec, x.shape, mesh, drop_trivial=True),
                      x.device_mesh)
    x = reduce_partial(x)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


class _SumPartial(torch.autograd.Function):
    """Partial -> Replicate, whose gradient stays replicated: the gradient
    of each summand is the sum's (Megatron's all-reduce, whose backward
    is the identity).  ``redistribute``'s backward would turn it into a
    ``Partial`` gradient, and DTensor would then gather weights or move
    activations in every backward product that meets it."""

    @staticmethod
    def forward(ctx, t):
        from torch.distributed.tensor import Replicate

        return t.redistribute(t.device_mesh, [
            Replicate() if pl.is_partial() else pl for pl in t.placements])

    @staticmethod
    def backward(ctx, grad):
        return grad


class _SumPartialGrad(torch.autograd.Function):
    """The identity, whose backward sums a ``Partial`` gradient (Megatron's
    "f": the input of a column-split product is replicated, the gradient
    each rank's product gives it is a partial sum)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        if not any(pl.is_partial() for pl in grad.placements):
            return grad
        from torch.distributed.tensor import Replicate

        return grad.redistribute(grad.device_mesh, [
            Replicate() if pl.is_partial() else pl for pl in grad.placements])


def sum_partial_grad(t: torch.Tensor) -> torch.Tensor:
    """`t`, whose gradient is summed over the ranks where it comes back as
    a ``Partial`` sum (an all-reduce in the backward); `t` itself when it
    is not a DTensor."""
    return _SumPartialGrad.apply(t) if is_dtensor(t) else t


def reduce_partial(t: torch.Tensor) -> torch.Tensor:
    """`t` with every ``Partial`` placement summed (an all-reduce; its
    gradient passes through replicated); `t` itself when it has none or
    is not a DTensor."""
    if not is_dtensor(t) or not any(pl.is_partial() for pl in t.placements):
        return t
    return _SumPartial.apply(t)


def whole_dim(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The DTensor `t` gathered on dim `dim` (an all-gather where it is
    split; `t` itself otherwise, and for a plain tensor).  Its backward
    hands each rank its own chunk of the gradient, where an op that
    gathers inside DTensor's dispatch leaves the gradient whole and the
    product before it computes every rank's columns."""
    if not is_dtensor(t):
        return t
    dim = dim % t.dim()
    if not any(pl.is_shard(dim) for pl in t.placements):
        return t
    from torch.distributed.tensor import Replicate

    return t.redistribute(t.device_mesh, [
        Replicate() if pl.is_shard(dim) else pl for pl in t.placements])


def split_dim(t: torch.Tensor, dim: int, sizes: tuple) -> torch.Tensor:
    """`t` with dim `dim` split into `sizes` (a reshape).  A DTensor split
    on that dim over more shards than ``sizes[0]`` divides is first
    gathered on it (8 kv heads of a 16-way "model" split: GSPMD would
    reshard the same way)."""
    dim = dim % t.dim()
    if is_dtensor(t):
        n = 1
        for i, pl in enumerate(t.placements):
            if pl.is_shard(dim):
                n *= t.device_mesh.shape[i]
        if sizes[0] % n:
            t = whole_dim(t, dim)
    return t.reshape(*t.shape[:dim], *sizes, *t.shape[dim + 1:])


class _MergeDims(torch.autograd.Function):
    """Dims `dim` and `dim` + 1 of a DTensor merged into one, whose gradient
    is split back with ``split_dim``: DTensor's own backward of the
    reshape cannot split a gradient sharded over more ranks than the outer
    dim divides (40 heads of a 16-way split)."""

    @staticmethod
    def forward(ctx, t, dim):
        ctx.dim, ctx.sizes = dim, (t.shape[dim], t.shape[dim + 1])
        return t.reshape(*t.shape[:dim], -1, *t.shape[dim + 2:])

    @staticmethod
    def backward(ctx, grad):
        return split_dim(grad, ctx.dim, ctx.sizes), None


def merge_dims(t: torch.Tensor, dim: int) -> torch.Tensor:
    """`t` with dims `dim` and `dim` + 1 merged (a reshape); on a DTensor
    the gradient is split back with ``split_dim``."""
    dim = dim % t.dim()
    if is_dtensor(t):
        return _MergeDims.apply(t, dim)
    return t.reshape(*t.shape[:dim], -1, *t.shape[dim + 2:])


def pad(t: torch.Tensor, widths: tuple, value: float = 0.0
        ) -> torch.Tensor:
    """``F.pad(t, widths, value=value)``; on a DTensor whose padded dims
    are not split, each rank pads its own shard (no collective: some
    PyTorch releases' DTensor rule for the pad returns placements of the
    wrong length on a 2-d mesh)."""
    import torch.nn.functional as F

    if not is_dtensor(t):
        return F.pad(t, widths, value=value)
    padded = {t.dim() - 1 - i // 2 for i, w in enumerate(widths) if w}
    pl = tuple(t.placements)
    if any(p.is_shard() and p.dim % t.dim() in padded for p in pl) \
            or any(p.is_partial() for p in pl):
        return F.pad(t, widths, value=value)
    return sharded_call(lambda x: F.pad(x, widths, value=value), (t,),
                        (pl,), pl, t.device_mesh)


def index_on(values: torch.Tensor, pls: tuple, dim: int, mesh):
    """The 1-d `values` (an index over some tensor's dim `dim`: its rows,
    experts or heads) as a DTensor on `mesh`, split over the mesh dims
    where the placements `pls` split that dim and whole on the rest: each
    rank holds the part of the index that its shard covers, and reads it
    without knowing its coordinate."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    want = [Shard(0) if p.is_shard(dim) else Replicate() for p in pls]
    return DTensor.from_local(values, mesh, [Replicate()] * mesh.ndim,
                              run_check=False).redistribute(mesh, want)


def sharded_call(fn, args: tuple, in_specs: tuple, out_specs,
                 mesh=None):
    """``fn`` on each rank's local shards of `args` (``local_map``): each
    DTensor argument is first redistributed to its spec in `in_specs` (a
    plain spec, or None for a non-tensor); the outputs are DTensors with
    `out_specs` (a spec, or a tuple of them for a tuple of outputs; a spec
    may also be a tuple of placements, e.g. with ``Partial()``).  Without
    a mesh, or with no DTensor among `args`, it is ``fn(*args)``.

    The gradient of an input replicated on a mesh dim is a ``Partial`` sum
    there when another input is split on that dim (weights applied to a
    batch shard) or an output is ``Partial`` on it; so `fn` must compute
    each rank's share of every output it declares ``Partial``, gradient
    paths included."""
    from torch.distributed.tensor import Partial, Placement
    from torch.distributed.tensor.experimental import local_map

    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or not any(is_dtensor(a) for a in args):
        return fn(*args)

    def place(spec):
        if spec is None:
            return None
        if spec and all(isinstance(p, Placement) for p in spec):
            return tuple(spec)
        return placements(spec, mesh)

    # local_map reads a tuple as one entry an output, a list as the
    # placements of a single output
    in_pl = tuple(place(s) for s in in_specs)
    if isinstance(out_specs, list):
        out_pl = tuple(list(place(s)) for s in out_specs)
        outs = out_pl
    else:
        out_pl = list(place(out_specs))
        outs = (out_pl,)
    # an input replicated on a mesh dim along which another input is split,
    # or the output is a partial sum, gets a partial sum of its gradient
    # from each rank there; elsewhere its gradient keeps its placement
    split = [any(p is not None and p[i].is_shard() for p in in_pl)
             or any(o[i].is_partial() for o in outs)
             for i in range(mesh.ndim)]
    grad_pl = tuple(None if p is None else tuple(
        Partial() if pl.is_replicate() and split[i] else pl
        for i, pl in enumerate(p)) for p in in_pl)
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)

"""Production mesh construction, the port of ``repro.launch.mesh``: a
(16, 16) ``("data", "model")`` mesh of 256 ranks or a (2, 16, 16)
``("pod", "data", "model")`` mesh of 512, built with ``init_device_mesh``
over the default process group.  Nothing here initialises a group: the
caller does (``launch.dryrun`` first thing, with a fake group of 256 or
512 ranks; a real run with its own backend)."""
from __future__ import annotations

from contextlib import contextmanager

__all__ = ["make_production_mesh", "mesh_rules", "one_rank_group",
           "MESH_SHAPES"]

MESH_SHAPES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda",
                         *, shape: tuple | None = None):
    """Single pod: 16 x 16 = 256 ranks (data, model).  Multi-pod: 2 pods of
    256 = 512 (pod, data, model).  `shape` builds another mesh over the
    same axes (a small one for tests, (1, 1) on one card).  Raises unless
    the default group's world size is the mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dshape, names = MESH_SHAPES[bool(multi_pod)]
    shape = tuple(shape or dshape)
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh needs an initialised "
                           "default process group")
    size = 1
    for s in shape:
        size *= s
    if dist.get_world_size() != size:
        raise ValueError(f"a {shape} mesh needs {size} ranks, the default "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def mesh_rules(mesh) -> dict:
    """Logical-axis rules for ``repro_torch.models.sharding.mesh_context``."""
    names = tuple(mesh.mesh_dim_names or ())
    dp = tuple(a for a in ("pod", "data") if a in names)
    return {"dp": dp, "model": ("model",), "sp": ("data",)}


@contextmanager
def one_rank_group(backend: str = "nccl"):
    """A default process group of one rank (rank 0 of 1) over an in-memory
    ``HashStore``, so the store opens no socket; destroyed on exit.  On a
    card, ``make_production_mesh(shape=(1, 1))`` over it runs a mesh step
    with real NCCL collectives of one rank."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialised")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()

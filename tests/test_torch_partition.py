"""The port's partition rule table (src/repro_torch/dist/partition.py) and
its mesh (launch/mesh.py) against the reference's (src/repro/dist/
partition.py, launch/mesh.py) on the CPU, leaf for leaf and as plain
tuples (a ``PartitionSpec`` is a tuple).

The reference side reads its abstract parameters (``eval_shape``) and an
``AbstractMesh`` with no devices; the port side reads ``meta`` parameters
and, for the mesh-dependent specs, the production meshes over a fake
process group of 256 and 512 ranks, built in a subprocess (a fake group
is never initialised in the test process).  Specs are compared with
equality: there is no arithmetic in them."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
from jax.sharding import AbstractMesh, PartitionSpec as P

import repro.configs as ref_configs
from repro.dist import partition as ref_partition
from repro.launch.specs import abstract_params as ref_abstract_params
import repro_torch.configs as configs
from repro_torch.dist import partition
from repro_torch.launch.specs import abstract_params
from repro_torch.train.step import leaf_paths
from repro_torch.models.lm import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
       "JAX_PLATFORMS": "cpu"}
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _ref_specs(tree) -> dict:
    """path -> spec tuple of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {ref_partition._path_str(p): tuple(s) for p, s in flat}


def _port_specs(specs, like) -> dict:
    return {p: tuple(s) for p, s in zip(leaf_paths(like),
                                        tree_leaves(specs))}


@pytest.fixture(scope="module")
def ref_params():
    return {a: ref_abstract_params(ref_configs.get_config(a))
            for a in ref_configs.ARCH_IDS}


@pytest.fixture(scope="module")
def port_mesh_specs():
    """zero_pspecs, batch_pspecs and dp_axes of every config on both
    production meshes, and the placements of two specs, from a subprocess
    holding the fake group."""
    code = r"""
import json
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.dist import partition
from repro_torch.launch.dryrun import production_mesh
from repro_torch.launch.mesh import make_production_mesh, mesh_rules
from repro_torch.launch.specs import abstract_params
from repro_torch.models.lm import tree_leaves
from repro_torch.train.step import leaf_paths
out = {}
for mp in (False, True):
    mesh = production_mesh(mp)
    name = "2x16x16" if mp else "16x16"
    cell = {"dp_axes": list(partition.dp_axes(mesh)),
            "rules": {k: list(v) for k, v in mesh_rules(mesh).items()},
            "zero": {}, "batch": {}, "embed_placements": None}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        params = abstract_params(cfg)
        z = partition.zero_pspecs(params, mesh)
        cell["zero"][arch] = dict(zip(leaf_paths(params),
                                      [list(s) for s in tree_leaves(z)]))
        b = make_batch_specs(cfg, 4096, 256)
        bs = partition.batch_pspecs(b, mesh)
        cell["batch"][arch] = {k: list(v) for k, v in bs.items()}
        if arch == "qwen3_1_7b":
            pl = partition.shardings(z, params, mesh)
            cell["embed_placements"] = [str(p) for p in pl["embed"]]
    try:
        make_production_mesh(not mp, device_type="cuda")
        cell["wrong_size"] = "no error"
    except ValueError as e:
        cell["wrong_size"] = str(e)
    out[name] = cell
print(json.dumps(out))
"""
    res = subprocess.run([sys.executable, "-c", code], env=ENV,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _tuplify(x):
    return tuple(_tuplify(e) for e in x) if isinstance(x, list) else x


@pytest.mark.parametrize("moe_ffn_tp", [False, True])
@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_param_pspecs_equal_reference(arch, moe_ffn_tp, ref_params):
    ref = _ref_specs(ref_partition.param_pspecs(ref_params[arch],
                                                moe_ffn_tp=moe_ffn_tp))
    params = abstract_params(configs.get_config(arch))
    got = _port_specs(partition.param_pspecs(params, moe_ffn_tp=moe_ffn_tp),
                      params)
    assert got == ref


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_zero_pspecs_equal_reference(arch, mesh_name, ref_params,
                                     port_mesh_specs):
    mesh = AbstractMesh(*MESHES[mesh_name])
    ref = _ref_specs(ref_partition.zero_pspecs(ref_params[arch], mesh))
    got = {p: _tuplify(s)
           for p, s in port_mesh_specs[mesh_name]["zero"][arch].items()}
    assert got == ref


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_pspecs_and_dp_axes_equal_reference(mesh_name,
                                                  port_mesh_specs):
    from repro.data.pipeline import make_batch_specs as ref_batch_specs
    from repro.launch.mesh import mesh_rules as ref_mesh_rules

    mesh = AbstractMesh(*MESHES[mesh_name])
    cell = port_mesh_specs[mesh_name]
    assert tuple(cell["dp_axes"]) == ref_partition.dp_axes(mesh)
    assert {k: tuple(v) for k, v in cell["rules"].items()} \
        == ref_mesh_rules(mesh)
    for arch in ref_configs.ARCH_IDS:
        b = ref_batch_specs(ref_configs.get_config(arch), 4096, 256)
        ref = {k: tuple(v) for k, v in
               ref_partition.batch_pspecs(b, mesh).items()}
        got = {k: _tuplify(v) for k, v in cell["batch"][arch].items()}
        assert got == ref, arch


def test_placements_shard_pod_major(port_mesh_specs):
    """qwen3-1.7b's ``embed`` ZeRO spec, ('model', 'data') on 16x16 and
    ('model', ('pod', 'data')) on 2x16x16, as placements: dim 1 over the
    data axes (pod before data), dim 0 over "model"."""
    assert port_mesh_specs["16x16"]["embed_placements"] \
        == ["S(1)", "S(0)"]
    assert port_mesh_specs["2x16x16"]["embed_placements"] \
        == ["S(1)", "S(1)", "S(0)"]
    ref = ref_partition.zero_pspecs(
        ref_abstract_params(ref_configs.get_config("qwen3-1.7b")),
        AbstractMesh(*MESHES["2x16x16"]))["embed"]
    assert tuple(ref) == ("model", ("pod", "data"))


def test_production_mesh_checks_the_world_size(port_mesh_specs):
    assert "needs 512 ranks" in port_mesh_specs["16x16"]["wrong_size"]
    assert "needs 256 ranks" in port_mesh_specs["2x16x16"]["wrong_size"]


def test_placements_of_plain_specs():
    """Spec -> placements needs only the mesh's names and sizes."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.sharding import fit_spec, placements

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)

    m = Mesh()
    assert placements((None, ("pod", "data"), "model"), m) \
        == (Shard(1), Shard(1), Shard(2))
    assert placements((), m) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        placements((("data", "pod"),), m)
    # 8 kv heads do not split 16 ways; 1 row does not split at all
    assert fit_spec(("data", None, "model"), (32, 7, 8), m) \
        == ("data", None, None)
    assert fit_spec((("pod", "data"), "model"), (32, 16), m) \
        == (("pod", "data"), "model")

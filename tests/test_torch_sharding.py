"""The port's logical sharding (src/repro_torch/models/sharding.py, the
``shard`` calls in models/, K4 / K5 / the MoE through ``local_map``, the
train step's bucket order) on the CPU.

``logical_spec`` is held to the reference's (src/repro/models/
sharding.py) with equality, for the axes of every ``shard`` call the
reference's models make, found in its sources.  The sharded computations
run in a subprocess (a fake process group is never initialised in the test
process) under ``LocalTensorMode``, which runs every rank of a (2, 2) mesh
in one process with real values (tinyllama, mamba2 with K5's local scan
and the MoE); they are held to the same computation
without a mesh, in float32: the loss within 1e-5 relative, each gradient
leaf within 1e-5 of that leaf's largest |gradient| (measured: 1.2e-6; the
ranks sum partial products in another order).  The MoE runs its
``shard_map`` routing, whose auxiliary loss is, as the reference's, the
mean over data shards of each shard's own (so the loss is compared with
``aux_weight=0`` and the aux with that mean)."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from jax.sharding import AbstractMesh

from repro.launch.mesh import mesh_rules as ref_mesh_rules
from repro.models import sharding as ref_sharding
from repro_torch.models import sharding

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
       "JAX_PLATFORMS": "cpu"}
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
TOL = 1e-5


def _shard_calls(path: Path) -> list:
    """The axes of each ``shard(x, axes)`` call in a module, an
    ``a if c else b`` entry expanded into both."""
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") \
                == "shard" and len(node.args) == 2:
            variants = [[]]
            for e in node.args[1].elts:
                opts = [e.body, e.orelse] if isinstance(e, ast.IfExp) else [e]
                variants = [v + [ast.literal_eval(o)] for v in variants
                            for o in opts]
            out.extend(tuple(v) for v in variants)
    return out


def _calls_by_file(pkg: str) -> dict:
    base = ROOT / "src" / pkg / "models"
    return {p.name: _shard_calls(p) for p in sorted(base.glob("*.py"))
            if p.name != "sharding.py"}


def test_port_makes_the_references_shard_calls():
    """Each model module calls ``shard`` as often as the reference's, with
    the same axes in the same order."""
    ref, port = _calls_by_file("repro"), _calls_by_file("repro_torch")
    ref = {k: v for k, v in ref.items() if v}
    assert {k: v for k, v in port.items() if v} == ref
    # 30 call sites; lm.py's residual one has two variants (seq_parallel)
    assert sum(len(v) for v in ref.values()) == 31


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_logical_spec_equals_reference(mesh_name):
    class Mesh:    # the names and sizes are all logical_spec reads
        mesh_dim_names = MESHES[mesh_name][1]
        shape = MESHES[mesh_name][0]

    amesh = AbstractMesh(*MESHES[mesh_name])
    rules = ref_mesh_rules(amesh)
    axes = sorted({a for calls in _calls_by_file("repro").values()
                   for a in calls}, key=repr)
    with ref_sharding.mesh_context(amesh, rules):
        ref = [tuple(ref_sharding.logical_spec(a)) for a in axes]
    with sharding.mesh_context(Mesh(), rules):
        got = [sharding.logical_spec(a) for a in axes]
    assert got == ref
    assert sharding.logical_spec(axes[0]) is None


def test_shard_outside_a_mesh_returns_its_input():
    x = torch.ones(4, 3)
    assert sharding.shard(x, ("dp", None)) is x
    assert sharding.sharded_call(lambda a: a, (x,), ((None, None),),
                                 (None, None)) is x


CHECKS = r"""
import dataclasses, json
import torch
from torch.distributed._local_tensor import LocalTensorMode
from repro_torch.configs import get_config
from repro_torch.dist import partition
from repro_torch.dist.planner import record_collectives
from repro_torch.launch.dryrun import init_fake_group
from repro_torch.launch.mesh import make_production_mesh, mesh_rules
from repro_torch.models import lm_loss
from repro_torch.models.layers import attention
from repro_torch.models.lm import tree_leaves
from repro_torch.models.moe import moe_ffn, moe_ffn_shard_map
from repro_torch.models.sharding import mesh_context
from repro_torch.train.step import (_apply_bucket_order, init_params,
                                    leaf_paths, tree_unflatten)

def full(t):
    # the value a DTensor holds, one tensor (every rank's copy agrees)
    f = t.full_tensor() if hasattr(t, "full_tensor") else t
    loc = getattr(f, "_local_tensors", None)
    if loc is None:
        return f
    vals = list(loc.values())
    assert all(torch.equal(vals[0], v) for v in vals), "ranks disagree"
    return vals[0]

def loss_and_grads(cfg, params, tok, lab, mesh=None, aux_weight=0.01):
    if mesh is not None:
        params = partition.distribute(params, partition.param_pspecs(params),
                                      mesh)
        b = partition.distribute({"t": tok, "l": lab}, partition.batch_pspecs(
            {"t": tok, "l": lab}, mesh), mesh)
        tok, lab = b["t"], b["l"]
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    if mesh is None:
        loss = lm_loss(cfg, tree_unflatten(params, live), tok, lab,
                       aux_weight=aux_weight)
        grads = torch.autograd.grad(loss, live)
    else:
        with mesh_context(mesh, mesh_rules(mesh)):
            loss = lm_loss(cfg, tree_unflatten(params, live), tok, lab,
                           aux_weight=aux_weight)
            grads = torch.autograd.grad(loss, live)
    return full(loss), [full(g) for g in grads]

def compare(cfg, aux_weight=0.01):
    g = torch.Generator().manual_seed(0)
    params = init_params(cfg, g, device="cpu")
    tok = torch.randint(0, cfg.vocab, (4, 12), generator=g)
    lab = torch.randint(0, cfg.vocab, (4, 12), generator=g)
    l0, g0 = loss_and_grads(cfg, params, tok, lab, aux_weight=aux_weight)
    with LocalTensorMode(4):
        mesh = make_production_mesh(shape=(2, 2), device_type="cpu")
        l1, g1 = loss_and_grads(cfg, params, tok, lab, mesh, aux_weight)
    errs = {p: float((a - b).abs().max() / a.abs().max().clamp(min=1e-30))
            for p, a, b in zip(leaf_paths(params), g0, g1)}
    return {"loss": float(l0), "loss_mesh": float(l1),
            "grad_err": max(errs.values()), "leaves": len(errs)}

out = {}
init_fake_group(4)
out["tinyllama"] = compare(get_config("tinyllama-1.1b").smoke())
out["mamba2"] = compare(get_config("mamba2-2.7b").smoke())
moe = get_config("granite-moe-3b").smoke()
moe = moe.replace(moe=dataclasses.replace(moe.moe, impl="shard_map"))
out["moe"] = compare(moe, aux_weight=0.0)

# one MoE layer: outputs and the per-data-shard aux loss
g = torch.Generator().manual_seed(1)
p = init_params(moe, g, device="cpu")["stack"]["l0"]["moe"]
p = {k: v[0] for k, v in p.items() if k != "norm"}
x = torch.randn(4, 6, moe.d_model, generator=g)
y0, _ = moe_ffn(moe, p, x)
aux0 = torch.stack([moe_ffn(moe, p, x[i:i + 2])[1] for i in (0, 2)]).mean()
with LocalTensorMode(4):
    mesh = make_production_mesh(shape=(2, 2), device_type="cpu")
    spec = partition.param_pspecs({"moe": {k: v[None] for k, v in p.items()}})
    pd = partition.distribute(
        p, {k: s[1:] for k, s in spec["moe"].items()}, mesh)
    xd = partition.distribute({"x": x}, {"x": ("data",)}, mesh)["x"]
    with mesh_context(mesh, mesh_rules(mesh)):
        y1, aux1 = moe_ffn_shard_map(moe, pd, xd)
    out["moe_layer"] = {
        "y_err": float((y0 - full(y1)).abs().max() / y0.abs().max()),
        "aux": float(aux0), "aux_mesh": float(full(aux1)),
        "w_gate": [str(pl) for pl in pd["w_gate"].placements]}

# GQA on a 4-way model axis: 4 q heads, 2 kv heads
cfg = get_config("qwen3-1.7b").smoke().replace(n_heads=4, n_kv_heads=2)
q = torch.randn(2, 8, 4, 16, generator=g, requires_grad=True)
k = torch.randn(2, 8, 2, 16, generator=g, requires_grad=True)
v = torch.randn(2, 8, 2, 16, generator=g, requires_grad=True)
dout = torch.randn(2, 8, 4, 16, generator=g)
o0 = attention(cfg, q, k, v)
d0 = torch.autograd.grad(o0, (q, k, v), dout)
with LocalTensorMode(4):
    mesh = make_production_mesh(shape=(1, 4), device_type="cpu")
    spec = {"q": ("data", None, "model"), "k": ("data",), "v": ("data",),
            "d": ("data", None, "model")}
    t = partition.distribute({"q": q, "k": k, "v": v, "d": dout}, spec, mesh)
    with mesh_context(mesh, mesh_rules(mesh)):
        o1 = attention(cfg, t["q"], t["k"], t["v"])
        d1 = torch.autograd.grad(o1, (t["q"], t["k"], t["v"]), t["d"])
    out["gqa"] = {"placements": [str(pl) for pl in o1.placements],
                  "out_err": float((o0 - full(o1)).abs().max()),
                  "grad_err": max(float((a - full(b)).abs().max())
                                  for a, b in zip(d0, d1))}

# the bucket order on a fake (2, 4) mesh, read by the recorder
init_fake_group(8)
mesh = make_production_mesh(shape=(2, 4), device_type="cpu")
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
sizes = {"a": 3, "b": 5, "c": 7, "d": 11}
grads = {n: DTensor.from_local(torch.empty(s, 4, device="meta"), mesh,
                               [Partial(), Replicate()], run_check=False)
         for n, s in sizes.items()}
like = {n: DTensor.from_local(torch.empty(s, 4, device="meta"), mesh,
                              [Replicate(), Replicate()], run_check=False)
        for n, s in sizes.items()}
like["d"] = DTensor.from_local(torch.empty(11, 1, device="meta"), mesh,
                               [Replicate(), Shard(1)], run_check=False)
order = [["c"], ["a", "zz"], ["d"]]
with record_collectives(mesh) as ops:
    done = _apply_bucket_order(grads, order, like)
out["buckets"] = {"ops": [[o.kind, o.bytes, o.axis] for o in ops],
                  "placements": {n: [str(pl) for pl in t.placements]
                                 for n, t in done.items()}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def checks():
    res = subprocess.run([sys.executable, "-c", CHECKS], env=ENV,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("model", ["tinyllama", "mamba2", "moe"])
def test_loss_and_gradients_on_a_mesh_equal_unsharded(checks, model):
    got = checks[model]
    assert abs(got["loss_mesh"] - got["loss"]) <= TOL * abs(got["loss"])
    assert got["grad_err"] <= TOL, got


def test_moe_shard_map_routes_each_data_shard(checks):
    got = checks["moe_layer"]
    assert got["w_gate"] == ["R", "S(0)"]          # EP: experts over model
    assert got["y_err"] <= TOL
    assert abs(got["aux_mesh"] - got["aux"]) <= TOL * abs(got["aux"])


def test_gqa_kv_heads_that_do_not_split_the_model_axis(checks):
    """4 q heads and 2 kv heads on a 4-way "model" axis: each rank takes
    the kv head of its own q head, and gives the unsharded attention."""
    got = checks["gqa"]
    assert got["placements"] == ["R", "S(2)"]    # one data shard
    assert got["out_err"] <= TOL and got["grad_err"] <= TOL, got


def test_bucket_order_is_the_collectives_launch_order(checks):
    """Each bucket's Partial gradients are all-reduced over "data" in the
    planned order (c, a, d), an unknown path skipped and the leaf no bucket
    lists (b) last; d goes to its moments' Shard(1) over "model" after its
    all-reduce."""
    got = checks["buckets"]
    per_rank = {"c": 7 * 4 * 4, "a": 3 * 4 * 4, "d": 11 * 4 * 4,
                "b": 5 * 4 * 4}
    assert got["ops"] == [["all-reduce", float(per_rank[n]), "data"]
                          for n in ("c", "a", "d", "b")]
    assert got["placements"] == {"a": ["R", "R"], "b": ["R", "R"],
                                 "c": ["R", "R"], "d": ["R", "S(1)"]}

"""The port's dry run (src/repro_torch/launch/dryrun.py, launch/specs.py)
and its collective extractors (dist/planner.py: ``extract_collectives``,
the reference's HLO parser, and ``record_collectives``, the same list read
from a step on a DTensor mesh) against the reference's on the CPU.

The parsers are held to the reference's with equality, on the reference's
own HLO strings and on HLO the reference compiles for a SwiGLU MLP block
on 8 CPU devices.  The abstract specs are held to the reference's
``eval_shape`` in shape and type.  The traces run in subprocesses over a
fake process group (never initialised in the test process): FLOPs are
counted per rank, below DTensor, so they grow linearly with depth, exactly
(the property the reference's cost extrapolation wanted; every layer runs
in an eager trace), and argument bytes are rank 0's shards, which the test
works out from the placements.

What the recorder and XLA agree on, and where they part: the MLP block
(column-split w_gate / w_up, row-split w_down, batch over "data") gives
both one all-reduce of the block's output over "model", the same bytes.
They part where the two partitioners choose differently: attention whose
kv heads do not split "model" (the port gathers k and v whole and each
rank picks its q heads' kv heads; XLA may reshard otherwise), the
vocab-parallel loss (the port all-reduces the max and the sum of
exponentials), the vocab-parallel embedding (a Partial sum all-reduced)
and the MoE (the port all-reduces the experts' partial outputs over
"model" where the reference's GSPMD moves the buffer by all-to-all)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.configs as ref_configs
from repro.dist.planner import extract_collectives as ref_extract
from repro.launch import specs as ref_specs
from repro_torch.configs import SHAPES, get_config, shape_applicable
from repro_torch.dist.planner import CollectiveOp, extract_collectives
from repro_torch.launch import dryrun, specs
from repro_torch.models.lm import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
       "JAX_PLATFORMS": "cpu"}

REF_HLO = [
    """
  %all-reduce.5 = bf16[2048]{0} all-reduce(%a), replica_groups={{0,1}}
  %ag-start = (f32[128]{0}, f32[1024]{0}) all-gather-start(%b)
  %cp.1 = f32[64,4]{1,0} collective-permute(%c)
""",
    """
  %all-reduce.1 = bf16[1024,128]{1,0} all-reduce(bf16[1024,128]{1,0} %x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = f32[4096]{0} all-gather(f32[256]{0} %y), replica_groups=[8,2]<=[16]
  %a2a.2 = bf16[64,32]{1,0} all-to-all(bf16[64,32]{1,0} %z), replica_groups={{0,4,8,12}}
""",
]


def _ref_collective_bytes(text: str) -> dict:
    """The reference's parser, run in a subprocess: importing its module
    sets XLA's device count for the whole process."""
    code = ("import json, sys\n"
            "from repro.launch.dryrun import collective_bytes\n"
            "print(json.dumps([collective_bytes(t) for t in "
            "json.loads(sys.stdin.read())]))\n")
    res = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=ROOT,
                         input=json.dumps(text), capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _ops(ops) -> list:
    return [(o.kind, o.bytes, o.idx, o.axis) for o in ops]


COMPILE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.launch.mesh import mesh_rules
from repro.models.layers import init_mlp, mlp_block
from repro.models.sharding import mesh_context

cfg = get_config("tinyllama-1.1b").smoke()
import numpy as np
from jax.sharding import Mesh
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
p = init_mlp(cfg, jax.random.PRNGKey(0))
sh = {"norm": {"scale": P()}, "w_gate": P(None, "model"),
      "w_up": P(None, "model"), "w_down": P("model", None)}
x = jax.ShapeDtypeStruct((8, 16, cfg.d_model), jnp.float32)

def f(p, x):
    with mesh_context(mesh, mesh_rules(mesh)):
        return mlp_block(cfg, p, x)

ns = lambda s: NamedSharding(mesh, s)
jitted = jax.jit(f, in_shardings=(jax.tree.map(ns, sh, is_leaf=lambda s: isinstance(s, P)), ns(P("data"))),
                 out_shardings=ns(P("data")))
print(json.dumps({"mlp": jitted.lower(p, x).compile().as_text()}))
"""

RECORD = r"""
import json
import torch
from repro_torch.configs import get_config
from repro_torch.dist import partition
from repro_torch.dist.planner import record_collectives
from repro_torch.launch.dryrun import init_fake_group
from repro_torch.launch.mesh import make_production_mesh, mesh_rules
from repro_torch.models.layers import init_mlp, mlp_block
from repro_torch.models.sharding import mesh_context, shard

init_fake_group(8)
mesh = make_production_mesh(shape=(2, 4), device_type="cuda")
cfg = get_config("tinyllama-1.1b").smoke()
p = init_mlp(cfg, None, device="meta")
spec = {"norm": {"scale": ()}, "w_gate": (None, "model"),
        "w_up": (None, "model"), "w_down": ("model", None)}
p = partition.distribute(p, spec, mesh)
x = partition.distribute({"x": torch.empty(8, 16, cfg.d_model, device="meta")},
                         {"x": ("data",)}, mesh)["x"]
with mesh_context(mesh, mesh_rules(mesh)), record_collectives(mesh) as ops:
    # the block's output, a Partial sum over "model", at the sharding the
    # reference's jit gives it (out_shardings P("data"))
    shard(mlp_block(cfg, p, x), ("dp", None, None))
print(json.dumps({"mlp": [[o.kind, o.bytes, o.axis] for o in ops]}))
"""


def _run(code: str) -> dict:
    res = subprocess.run([sys.executable, "-c", code], env=ENV, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def compiled_mlp() -> str:
    return _run(COMPILE)["mlp"]


@pytest.fixture(scope="module")
def recorded_mlp() -> list:
    return _run(RECORD)["mlp"]


def test_parsers_equal_reference_on_its_hlo_strings():
    ref = _ref_collective_bytes(REF_HLO)
    for text, want in zip(REF_HLO, ref):
        assert dryrun.collective_bytes(text) == want
        assert _ops(extract_collectives(text)) == _ops(ref_extract(text))
    assert [o.axis for o in extract_collectives(REF_HLO[1])] \
        == ["model", "model", "data"]


def test_parsers_equal_reference_on_compiled_hlo(compiled_mlp):
    assert "all-reduce" in compiled_mlp
    assert dryrun.collective_bytes(compiled_mlp) \
        == _ref_collective_bytes([compiled_mlp])[0]
    assert _ops(extract_collectives(compiled_mlp)) \
        == _ops(ref_extract(compiled_mlp))


def test_recorder_finds_the_mlp_collectives_xla_finds(compiled_mlp,
                                                      recorded_mlp):
    """The SwiGLU MLP block on the same (2, 4) mesh: kind, bytes and axis
    of every collective, in order."""
    ref = [[o.kind, o.bytes, o.axis] for o in ref_extract(compiled_mlp)]
    assert recorded_mlp == ref
    assert ref == [["all-reduce", 4 * 16 * 64 * 4.0, "model"]]


def test_collective_bytes_of_a_recorded_program():
    ops = [CollectiveOp("all-reduce", 8.0, 0, "data"),
           CollectiveOp("all-gather", 4.0, 1, "model"),
           CollectiveOp("all-reduce", 2.0, 2, "model")]
    assert dryrun.collective_bytes_of(ops) == {
        "all-reduce": 10.0, "all-gather": 4.0, "total": 14.0, "n_ops": 3}


def _ref_struct(tree) -> list:
    return [(tuple(x.shape), np.dtype(x.dtype).name)
            for x in jax.tree_util.tree_leaves(tree)]


def _port_struct(tree) -> list:
    import torch

    def name(t):
        return str(t.dtype).removeprefix("torch.")

    out = []
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            out.append((tuple(x.shape), name(x)))
    return out


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_abstract_state_equals_reference(arch):
    ref = ref_specs.abstract_state(ref_configs.get_config(arch))
    st = specs.abstract_state(get_config(arch))
    got = _port_struct({"params": st.params, "opt": st.opt,
                        "step": st.step})
    want = _ref_struct({"params": ref.params, "opt": ref.opt,
                        "step": ref.step})
    assert got == want
    assert all(t.device.type == "meta" for t in tree_leaves(st.params))


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_input_specs_and_cache_equal_reference(arch):
    rcfg, cfg = ref_configs.get_config(arch), get_config(arch)
    for shape in SHAPES:
        got = specs.input_specs(cfg, shape)
        want = ref_specs.input_specs(rcfg, shape)
        if "cache" in got:
            # the port keeps the length a Python int, as decode_step does
            assert got["cache"].pop("length") == 0
            want = dict(want, cache={k: v for k, v in want["cache"].items()
                                     if k != "length"})
        assert _port_struct(got) == _ref_struct(want), shape
    c = specs.abstract_cache(cfg, 2, 64)
    r = ref_specs.abstract_cache(rcfg, 2, 64)
    assert _port_struct({k: v for k, v in c.items() if k != "length"}) \
        == _ref_struct({k: v for k, v in r.items() if k != "length"})


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_skip_reasons_equal_reference(arch):
    for shape in SHAPES:
        ok, reason = shape_applicable(get_config(arch), shape)
        assert (ok, reason) == ref_configs.shape_applicable(
            ref_configs.get_config(arch), shape)
        if not ok:
            got = dryrun.run_cell(arch, shape, verbose=False)
            assert got == {"arch": arch, "shape": shape, "mesh": "16x16",
                           "status": "skipped", "reason": reason}


TRACE = r"""
import json
from repro_torch.configs import SHAPES, get_config
from repro_torch.dist.partition import param_pspecs, batch_pspecs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import abstract_state, input_specs
from repro_torch.models.lm import tree_leaves
from repro_torch.models.sharding import fit_spec, mesh_axis_size

dryrun.init_fake_group(8)
mesh = make_production_mesh(shape=(2, 4), device_type="cuda")
base = get_config("tinyllama-1.1b").smoke()
out = {"flops": {}, "ops": {}}
for depth in (1, 2, 3):
    cfg = base.replace(n_periods=depth)
    r = dryrun.run_cell("tinyllama-1.1b", "train_4k", cfg=cfg, mesh=mesh,
                        verbose=False)
    out["flops"][depth] = r["cost"]["flops"]
    out["ops"][depth] = r["collectives"]["n_ops"]
    if depth == 2:
        out["cell"] = {k: r[k] for k in ("status", "memory", "roofline",
                                         "collectives")}
        # rank 0's share worked out from the specs: each leaf's bytes over
        # the shards its fitted spec makes
        st = abstract_state(cfg)
        ps = param_pspecs(st.params)
        def share(t, s):
            n = 1
            for d, e in enumerate(fit_spec(s, t.shape, mesh)):
                n *= mesh_axis_size(mesh, e)
            return t.numel() * t.element_size() // n
        hand = sum(share(t, s) for tree in (st.params, st.opt["m"],
                                            st.opt["v"])
                   for t, s in zip(tree_leaves(tree), tree_leaves(ps)))
        hand += st.step.element_size() + st.opt["step"].element_size()
        b = input_specs(cfg, "train_4k")["batch"]
        hand += sum(share(b[k], s) for k, s in batch_pspecs(b, mesh).items())
        out["hand_bytes"] = hand
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def traced():
    return _run(TRACE)


def test_flops_grow_linearly_with_depth(traced):
    f = {int(k): v for k, v in traced["flops"].items()}
    assert f[1] > 0 and f[2] > f[1]
    assert f[3] == f[1] + 2 * (f[2] - f[1])


def test_argument_bytes_are_rank_zeros_shards(traced):
    mem = traced["cell"]["memory"]
    assert mem["argument_size_in_bytes"] == traced["hand_bytes"]
    assert mem["peak_live_bytes"] > mem["argument_size_in_bytes"]


def test_cell_reports_the_roofline_and_collectives(traced):
    cell = traced["cell"]
    assert cell["status"] == "ok"
    r = cell["roofline"]
    assert r["bottleneck"] == max(("compute_s", "memory_s",
                                   "collective_s"), key=r.get)
    coll = cell["collectives"]
    assert coll["total"] == sum(v for k, v in coll.items()
                                if k not in ("total", "n_ops"))
    assert coll["n_ops"] > 0 and coll.get("all-reduce", 0) > 0

"""Multi-pod dry run, the port of ``repro.launch.dryrun`` on DTensor: trace
every (arch x shape x mesh) cell on the production mesh (16 x 16 = 256 or
2 x 16 x 16 = 512 ranks) without a device, and read its per-device costs.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --single-pod-only

How: a **fake process group** (``torch.testing``'s ``fake`` backend, rank
0 of 256 or 512, collectives that move nothing) gives the mesh its size;
the mesh is a ``cuda`` DeviceMesh, so DTensor plans the collectives NCCL
would run (all-to-all where a CPU mesh would gather).  Parameters, the
optimizer state, the inputs and the caches are ``meta`` tensors (shapes
only), distributed by the rule table (``dist.partition``) as DTensors; the
step runs eagerly on them under ``mesh_context``, and a dispatch mode
below DTensor (``StepTracer``) reads rank 0's local ops.  The kernels take
their plain versions on ``meta``, as the reference's cost probe forces its
einsum attention.  Every number is a trace on a fake group, rank 0's
share, not a run.

What a cell reports (the reference's JSON keys where there is one):

* ``cost.flops``: FLOPs of rank 0's local ops (``torch.utils.flop_counter``'s
  formulas: matrix products and attention; elementwise ops count 0), the
  reference's per-device ``flops`` after SPMD.  Counted below DTensor:
  above it a counter sees global shapes.
* ``cost["bytes accessed"]``: the bytes each local ``aten`` op that is not
  a view reads and writes (each tensor argument once, each tensor result
  once; ``empty``-like allocations and collectives excluded).  XLA's
  figure counts fused ops once; this counts every eager op, so it is an
  upper bound of what a fused step moves.
* ``memory.argument_size_in_bytes``: rank 0's local shards of the state
  and the inputs, exact.  ``memory.peak_live_bytes``: that plus the peak
  of the storages rank 0's local ops made and still held (tracked by weak
  references); it leaves out the allocator's rounding and caching,
  libraries' workspaces and buffers made outside a traced op.
* ``collectives``: the recorded program's bytes by kind
  (``collective_bytes_of``), with ``n_ops``; ``collective_ops`` lists each
  op (kind, bytes, axis), the input of ``dist.planner.coflows_from_step``.
* ``roofline``: compute, memory and collective seconds on one NVIDIA H100
  SXM at its data sheet's peaks and the bottleneck.

There is no cost probe and no extrapolation (the reference's
``cost_probe`` / ``_numeric_extrapolate``): XLA counts a ``while`` body
once, an eager trace runs every layer.
"""
from __future__ import annotations

import argparse
import json
import re
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils.flop_counter import flop_registry

from ..dist.planner import _DTYPE_BYTES, CollectiveRecorder

__all__ = ["init_fake_group", "collective_bytes", "collective_bytes_of",
           "StepTracer", "build_cell", "run_cell", "main", "PEAK_FLOPS",
           "HBM_BW", "LINK_BW"]

OUT_DEFAULT = Path(__file__).resolve().parents[3] / "build" / "dryrun.json"

# --- NVIDIA H100 SXM5 roofline (NVIDIA H100 Tensor Core GPU data sheet;
# dense rates at the 700 W limit) --------------------------------------------
PEAK_FLOPS = 989e12     # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12        # HBM3 bytes/s
LINK_BW = 450e9         # NVLink 4 bytes/s a direction (900 GB/s both ways)

_COLL_RE = re.compile(
    r"=\s*(?:\([^)]*\)|[a-z0-9]+\[[0-9,]*\]\S*)\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?(?:\.\d+)?\(")
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def init_fake_group(world_size: int) -> None:
    """Make the default process group a fake one of `world_size` ranks
    (this process is rank 0); a fake group of another size is replaced."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world_size \
                and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())


def collective_bytes(hlo_text: str) -> dict:
    """Per-device bytes of every collective op in a compiled (post-SPMD)
    XLA HLO module, by kind, with ``total`` and ``n_ops``: the reference's
    parser as it is (it sizes each op's result)."""
    out: dict[str, float] = {}
    n_ops = 0
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if m is None:
            continue
        kind = m.group(1)
        lhs = line[: m.start(1)]
        total = 0.0
        for dt, dims in _SHAPE_RE.findall(lhs):
            if dt not in _DTYPE_BYTES:
                continue
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            total += n * _DTYPE_BYTES[dt]
        out[kind] = out.get(kind, 0.0) + total
        n_ops += 1
    out["total"] = sum(v for k, v in out.items() if k != "total")
    out["n_ops"] = n_ops
    return out


def collective_bytes_of(ops) -> dict:
    """``collective_bytes``' figures from a recorded program (a list of
    ``CollectiveOp``): bytes by kind, ``total`` and ``n_ops``."""
    out: dict[str, float] = {}
    for op in ops:
        out[op.kind] = out.get(op.kind, 0.0) + op.bytes
    out["total"] = sum(out.values())
    out["n_ops"] = len(ops)
    return out


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


_ALLOCS = ("empty", "empty_like", "empty_strided", "new_empty",
           "new_empty_strided")


class StepTracer(CollectiveRecorder):
    """The collective recorder, and rank 0's FLOPs, bytes accessed and the
    peak of its live storages over the same local ops (see the module)."""

    def __init__(self, mesh):
        super().__init__(mesh)
        self.flops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self._held: dict[int, list] = {}   # storage -> [bytes, refs]

    def _release(self, key: int) -> None:
        held = self._held[key]
        held[1] -= 1
        if held[1] == 0:
            self.live -= held[0]
            del self._held[key]

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        held = self._held.get(key)
        if held is None:
            held = self._held[key] = [st.nbytes(), 0]
            self.live += held[0]
            self.peak = max(self.peak, self.live)
        held[1] += 1
        weakref.finalize(t, self._release, key)

    def observe(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        outs = list(_tensors(out))
        if func.namespace == "aten" and not func.is_view \
                and func._opname not in _ALLOCS:
            self.bytes_accessed += sum(
                t.numel() * t.element_size()
                for t in (*_tensors(args), *_tensors(list(kwargs.values())),
                          *outs))
        for t in outs:
            self._hold(t)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def _cache_pspecs(cfg, mesh, batch: int, seq_shard: bool,
                  layout: str = "heads"):
    """Decode-cache specs, the reference's: seq_shard=True (long_500k,
    batch 1) shards the KV / conv sequence axis on "data" (SP) instead of
    batch.  layout="heads" shards KV on the kv-head dim, "dh" on the head
    dim, "seq" on the sequence.  Returns a function of the cache tree."""
    from ..dist.partition import dp_axes
    from ..models.sharding import mesh_axis_size

    dp = dp_axes(mesh)
    dp_total = mesh_axis_size(mesh, dp) if dp else 1
    bdim = dp if batch % max(dp_total, 1) == 0 and batch >= dp_total \
        else None
    bdim = bdim if bdim is None or len(bdim) > 1 else bdim[0]

    def leaf_spec(name, nd):
        if name in ("k", "v", "self_k", "self_v", "cross_k", "cross_v"):
            # (nP, B, S, Hkv, dh)
            if layout == "dh":
                return (None, None if seq_shard else bdim,
                        "data" if seq_shard else None, None, "model")
            if layout == "seq":
                return (None, None if seq_shard else bdim, "model", None,
                        None)
            return (None, None if seq_shard else bdim,
                    "data" if seq_shard else None, "model", None)
        if name == "h":     # (nP, B, H, N, P)
            return (None, bdim, "model", None, None)
        if name == "conv":  # (nP, B, K-1, C)
            return (None, bdim, None, "model")
        return (None,) * nd

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if not isinstance(tree, torch.Tensor):
            return None
        return leaf_spec(name, tree.dim())

    return walk


def build_cell(cfg, shape_name: str, mesh, variant: dict | None = None):
    """Returns (fn, args, specs): the step, its ``meta`` arguments and a
    spec tree for each argument (None for a leaf that stays as it is).
    ``fn(*args)`` runs the step once each argument is distributed by its
    specs (``dist.partition.distribute``)."""
    from ..configs import SHAPES
    from ..dist.partition import batch_pspecs, param_pspecs, state_pspecs
    from ..models.sharding import mesh_context
    from .mesh import mesh_rules
    from .specs import abstract_params, abstract_state, input_specs

    variant = variant or {}
    cfg = cfg.replace(**variant.get("config", {}))
    shape = SHAPES[shape_name]
    specs = input_specs(cfg, shape)
    rules = mesh_rules(mesh)

    if shape.kind == "train":
        from ..train.optim import OptConfig
        from ..train.step import build_train_step

        state = abstract_state(cfg)
        st_specs = state_pspecs(
            state.params, mesh, moe_ffn_tp=variant.get("moe_ffn_tp", False),
            zero=variant.get("zero", False))
        step = build_train_step(
            cfg, OptConfig(), micro_steps=variant.get("micro_steps", 1),
            bucket_order=variant.get("bucket_order"),
            grad_compression=variant.get("grad_compression", False))

        def fn(state_tree, batch):
            from ..train.step import TrainState
            st = TrainState(params=state_tree["params"],
                            opt=state_tree["opt"], step=state_tree["step"])
            with mesh_context(mesh, rules):
                return step(st, batch)

        tree = {"params": state.params, "opt": state.opt, "step": state.step}
        return fn, (tree, specs["batch"]), (
            st_specs, batch_pspecs(specs["batch"], mesh))

    params = abstract_params(cfg)
    ps = param_pspecs(params, moe_ffn_tp=variant.get("moe_ffn_tp", False))
    if shape.kind == "prefill":
        if cfg.family == "encdec":
            from ..models import encdec_prefill

            def fn(p, frames, tokens):
                with mesh_context(mesh, rules):
                    return encdec_prefill(cfg, p, frames, tokens,
                                          capacity=shape.seq_len)
            args = (params, specs["frames"], specs["tokens"])
        elif cfg.family == "vlm":
            from ..models import vlm_prefill

            def fn(p, patches, tokens):
                with mesh_context(mesh, rules):
                    return vlm_prefill(cfg, p, patches, tokens)
            args = (params, specs["patches"], specs["tokens"])
        else:
            from ..models import prefill

            def fn(p, tokens):
                with mesh_context(mesh, rules):
                    return prefill(cfg, p, tokens)
            args = (params, specs["tokens"])
        return fn, args, (ps, *[batch_pspecs(a, mesh) for a in args[1:]])

    # decode: one token against a full seq_len-capacity cache
    seq_shard = shape.global_batch == 1
    cache = specs["cache"]
    cache["length"] = shape.seq_len - 1
    c_specs = _cache_pspecs(cfg, mesh, shape.global_batch, seq_shard,
                            layout=variant.get("cache_layout", "heads"))(cache)
    tok_specs = batch_pspecs(specs["token"], mesh) \
        if shape.global_batch > 1 else (None, None)
    if cfg.family == "encdec":
        from ..models import encdec_decode_step as step_fn
    else:
        from ..models import decode_step as step_fn

    def fn(p, c, token):
        with mesh_context(mesh, rules):
            return step_fn(cfg, p, c, token)

    return fn, (params, cache, specs["token"]), (ps, c_specs, tok_specs)


def arg_bytes(tree) -> int:
    """Bytes of rank 0's share of a tree: each DTensor's local shard, each
    plain tensor whole."""
    from ..models.sharding import is_dtensor

    if isinstance(tree, dict):
        return sum(arg_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(arg_bytes(v) for v in tree)
    if not isinstance(tree, torch.Tensor):
        return 0
    t = tree.to_local() if is_dtensor(tree) else tree
    return t.numel() * t.element_size()


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def production_mesh(multi_pod: bool):
    """The production mesh over a fake group of its size (the group is
    made first; a ``cuda`` mesh, so DTensor plans NCCL's collectives)."""
    from .mesh import MESH_SHAPES, make_production_mesh

    shape, _ = MESH_SHAPES[bool(multi_pod)]
    world = 1
    for s in shape:
        world *= s
    init_fake_group(world)
    return make_production_mesh(multi_pod, device_type="cuda")


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             variant: dict | None = None, verbose: bool = True, *,
             mesh=None, cfg=None) -> dict:
    """Trace one cell; `mesh` (default the production mesh over a fake
    group) and `cfg` (default ``get_config(arch)``) may be given."""
    from ..configs import get_config, shape_applicable
    from ..dist.partition import distribute

    cfg = cfg if cfg is not None else get_config(arch)
    name = mesh_name(multi_pod) if mesh is None else "x".join(
        str(s) for s in mesh.shape)
    ok, reason = shape_applicable(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": name,
                "status": "skipped", "reason": reason}
    if mesh is None:
        mesh = production_mesh(multi_pod)
    t0 = time.time()
    fn, args, specs = build_cell(cfg, shape_name, mesh, variant)
    args = tuple(distribute(a, s, mesh) for a, s in zip(args, specs))
    n_arg = arg_bytes(args)
    t_build = time.time() - t0
    tracer = StepTracer(mesh)
    t0 = time.time()
    with tracer:
        fn(*args)
    t_trace = time.time() - t0
    coll = collective_bytes_of(tracer.ops)
    flops = float(tracer.flops)
    bytes_acc = float(tracer.bytes_accessed)
    res = {
        "arch": arch, "shape": shape_name, "mesh": name, "status": "ok",
        "variant": {k: v for k, v in (variant or {}).items()
                    if k != "bucket_order"},
        "traced_on": "fake process group, meta tensors (rank 0's share)",
        "build_s": round(t_build, 3), "trace_s": round(t_trace, 3),
        "memory": {
            "argument_size_in_bytes": n_arg,
            "peak_live_bytes": n_arg + tracer.peak,
            "per_device_total_gib": round((n_arg + tracer.peak) / 2 ** 30,
                                          3),
        },
        "cost": {"flops": flops, "bytes accessed": bytes_acc},
        "collectives": coll,
        "collective_ops": [[op.kind, op.bytes, op.axis]
                           for op in tracer.ops],
        "roofline": {
            "compute_s": flops / PEAK_FLOPS,
            "memory_s": bytes_acc / HBM_BW,
            "collective_s": coll["total"] / LINK_BW,
        },
    }
    r = res["roofline"]
    r["bottleneck"] = max(("compute_s", "memory_s", "collective_s"),
                          key=lambda k: r[k])
    if verbose:
        short = {k: v for k, v in res.items() if k != "collective_ops"}
        print(json.dumps(short, default=str), flush=True)
    return res


def main(argv=None) -> None:
    from ..configs import ARCH_IDS, SHAPES

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--out", default=str(OUT_DEFAULT))
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    cells: list[tuple[str, str, bool]] = []
    if args.all:
        for mp in ((False,) if args.single_pod_only else (False, True)):
            for arch in ARCH_IDS:
                for shape in SHAPES:
                    cells.append((arch, shape, mp))
    else:
        cells.append((args.arch, args.shape, args.multi_pod))
    # the fake group of the first cell's mesh comes before anything else
    production_mesh(cells[0][2])

    out_path = Path(args.out)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    results = []
    if out_path.exists():
        results = json.loads(out_path.read_text())

    def key(r):
        return (r["arch"], r["shape"], r["mesh"],
                json.dumps(r.get("variant", {}), sort_keys=True))

    done = {key(r) for r in results if r.get("status") in ("ok", "skipped")}
    for arch, shape, mp in cells:
        k = (arch, shape, mesh_name(mp), "{}")
        if k in done:
            print(f"cached: {k}")
            continue
        print(f"=== {arch} x {shape} x {mesh_name(mp)} ===", flush=True)
        try:
            res = run_cell(arch, shape, multi_pod=mp)
        except Exception:
            res = {"arch": arch, "shape": shape, "mesh": mesh_name(mp),
                   "status": "error",
                   "trace": traceback.format_exc()[-2000:]}
            print(res["trace"], flush=True)
        results = [r for r in results
                   if key(r) != key({**res, "variant": {}})]
        results.append(res)
        out_path.write_text(json.dumps(results, indent=1, default=str))
    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skipped")
    n_err = sum(1 for r in results if r["status"] == "error")
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_err} errors -> {out_path}")


if __name__ == "__main__":
    main()

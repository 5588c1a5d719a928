#!/usr/bin/env python3
"""How far qwen3-1.7b's bf16 training gradient lies from a float32 one, for
two checkouts of this repository, and how far one-ulp changes of the
attention outputs move it and a short run.

For each root, in its own process with ``ROOT/src`` on the path (so each
builds and loads its own kernels), on one card: the parameters of phase
16(a)'s run (full width, drawn from seed 0 as ``init_train_state`` draws
them) and its first batch (4 x 4096 tokens, ``SyntheticTokens`` at seed 0,
step 0); the gradient of the loss as the training step computes it (bf16),
and in float32 (the parameters cast to float32 and the model computing in
float32, so K4 runs its float32 FMA kernels, which the two roots share).
Each bf16 gradient against the float32 one: the loss, the grad norm (the
float32 L2 norm over every leaf, as the optimizer's clip reads it), the
relative gap ||g - g32|| / ||g32|| over all leaves, and the worst leaf's
relative gap with its path.

In B's process also, the same with every attention output moved by one
bf16 ulp up or down, the sign drawn from a hash of the element's bits and
position (unbiased, and the same when remat recomputes the layer), which is
the size of the rounding by which two correct bf16 kernels may differ; and
phase 16(a)'s run (4 steps through ``repro_torch.launch.train``'s ``main``)
as it is and with that change: each step's loss and grad norm.

    python3 scripts/train_sensitivity.py A_ROOT [B_ROOT]

B_ROOT defaults to this checkout.  Prints each root's JSON line, then the
card's name and power limit.  One card, about 5 minutes.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ,  # noqa: E402
                        TRAIN_STEPS, _train_full_width)


def one_ulp(out):
    """`out` (bf16) with every element moved by one bf16 ulp, up or down by
    a hash of its bits and its position; a zero is left as it is."""
    import torch

    with torch.no_grad():
        x = out.detach().float()
        _, e = torch.frexp(x)
        ulp = torch.ldexp(torch.ones_like(x), e - 8)   # 8 significand bits
        bits = out.detach().contiguous().view(torch.int16).to(torch.int32)
        idx = torch.arange(x.numel(), device=x.device,
                           dtype=torch.int32).view(x.shape)
        h = (bits * 40503 + idx * 34283) & 0xFFFF
        sign = ((h >> 8) & 1).float() * 2 - 1
        step = torch.where(x == 0, 0.0, sign * ulp)
    return (out.float() + step).to(out.dtype)


def gradients(root: Path, more: bool) -> dict:
    """One root's first-step gradients against float32; with `more`, also
    the one-ulp gradient and the two 4-step runs."""
    import dataclasses
    import gc

    import torch

    sys.path.insert(0, str(root / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core import clear_caches
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import layers
    from repro_torch.models.lm import tree_leaves
    from repro_torch.train.step import (_value_and_grad, init_params,
                                        leaf_paths, loss_for)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(TRAIN_ARCH)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    paths = leaf_paths(params)
    batch = SyntheticTokens(cfg, DataConfig(seq_len=TRAIN_SEQ,
                                            global_batch=TRAIN_BATCH,
                                            seed=0),
                            device=dev).batch_at(0)

    def free() -> None:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    loss32, g32 = _value_and_grad(loss_for(cfg32), _to_f32(params), batch)
    g32 = tree_leaves(g32)
    free()
    n32 = torch.stack([g.norm() for g in g32])
    out = {"root": str(root), "float32": {
        "loss": float(loss32), "grad_norm": float(n32.norm())}}

    def against_f32(fa) -> dict:
        orig = layers.flash_attention
        layers.flash_attention = fa
        try:
            loss, g = _value_and_grad(loss_for(cfg), params, batch)
        finally:
            layers.flash_attention = orig
        g = [x.float() for x in tree_leaves(g)]
        gap = torch.stack([(a - b).norm() for a, b in zip(g, g32)])
        rel = gap / n32.clamp_min(torch.finfo(torch.float32).tiny)
        worst = int(rel.argmax())
        res = {"loss": float(loss),
               "grad_norm": float(torch.stack([x.norm() for x in g]).norm()),
               "rel_gap": float(gap.norm() / n32.norm()),
               "worst_leaf_rel_gap": float(rel[worst]),
               "worst_leaf": paths[worst]}
        del g
        free()
        return res

    layers_fa = layers.flash_attention
    out["bf16"] = against_f32(layers_fa)
    if not more:
        return out

    def nudged(q, k, v, **kw):
        return one_ulp(layers_fa(q, k, v, **kw))

    out["bf16_one_ulp"] = against_f32(nudged)
    del g32, params, batch
    free()

    from repro_torch.kernels.bna_decompose import bna_decompose
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.merge_fix import merge_fix

    wrappers = {"flash_attention": flash_attention,
                "bna_decompose": bna_decompose, "merge_fix": merge_fix}

    def zero_counts() -> None:
        for w in wrappers.values():
            w.launches = 0

    def read_counts() -> dict:
        return {k: w.launches for k, w in wrappers.items()}

    per_step = {"flash_attention": 2 * cfg.n_layers}
    out["runs"] = {}
    for label, fa in (("as_is", layers_fa), ("one_ulp", nudged)):
        clear_caches()        # each run plans its buckets on the card anew
        layers.flash_attention = fa
        try:
            res, rec = _train_full_width(
                dev, (zero_counts, read_counts), TRAIN_ARCH, TRAIN_STEPS,
                TRAIN_SEQ, TRAIN_BATCH, per_step)
        finally:
            layers.flash_attention = layers_fa
        out["runs"][label] = {"loss": rec["loss"],
                              "grad_norm": rec["grad_norm"]}
        del res
        free()
    return out


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    return tree.float()


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--root"]:
        print(json.dumps(gradients(Path(sys.argv[2]).resolve(),
                                   sys.argv[3:4] == ["--more"])))
        return 0
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    roots = {"A": Path(sys.argv[1]).resolve(),
             "B": Path(sys.argv[2]).resolve() if len(sys.argv) > 2
             else ROOT}
    for name, root in roots.items():
        r = subprocess.run([sys.executable, __file__, "--root", str(root),
                            *(["--more"] if name == "B" else [])],
                           capture_output=True, text=True, timeout=1500)
        if r.returncode != 0:
            print(r.stdout, r.stderr, file=sys.stderr)
            return 1
        print(f"{name}: {r.stdout.strip().splitlines()[-1]}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

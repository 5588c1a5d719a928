#!/usr/bin/env python3
"""Time the planning path's kernels of two checkouts of this repository on
one card, in turns (A, B, B, A), at the main path's shapes:

- ``bna_step`` on a (14, 256, 256) int32 state (the python path's widest);
- ``coflow_merge`` on (K, 2m) = (5277, 300) and (119288, 300) deltas;
- ``merge_fix`` on K ~ 1.3e4 intervals of E = 267,537 edges and on
  K ~ 1.2e5 of E = 60,000, at m = 150, and on the largest merge of the
  pipeline's gdm and om_alg plans of ``paper_workload(m=150, mu_bar=5,
  seed=0, scale=1.0)``;
- ``bna_decompose`` on the widest bucket of the pipeline's gdm plan of
  ``paper_workload(m=150, mu_bar=5, seed=0, scale=0.25)`` (B=29, w=256);
- and the whole pipeline plan of gdm_rt on ``paper_workload(m=150,
  mu_bar=5, seed=0, scale=0.1, rooted=True)`` (host clock, synced, caches
  cleared before each of three rounds), whose merges run merge_and_fix's
  fix-up BNA.

    python3 scripts/kernel_ab.py A_ROOT [B_ROOT]

B_ROOT defaults to this checkout.  Each turn runs in its own process with
``A_ROOT/src`` or ``B_ROOT/src`` on the path, so each builds and loads its
own kernels.  Inputs come from fixed seeds and are the same in every turn.
Prints each turn's times and, per kernel, the median of each root's two
turns and their ratio, beside the card's name and power limit.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path


sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import _cuda_ms, _wall_ms  # noqa: E402


def time_root(root: Path) -> dict:
    """One turn: this root's kernels at the main path's shapes (ms)."""
    import numpy as np
    import torch

    sys.path.insert(0, str(root / "src"))
    from repro_torch.core import (backend, clear_caches, paper_workload,
                                  pipeline, plan)
    from repro_torch.kernels.bna_decompose import bna_decompose
    from repro_torch.kernels.bna_step import bna_step, stage_state
    from repro_torch.kernels.coflow_merge import coflow_merge
    from repro_torch.kernels.merge_fix import merge_fix

    dev = torch.device("cuda")
    out = {}
    rng = np.random.default_rng(0)
    d = rng.integers(0, 40, size=(14, 256, 256))
    d[rng.random(d.shape) > 0.6] = 0
    row, col = d.sum(axis=2), d.sum(axis=1)
    match = np.stack([np.where(rng.random(256) < 0.8, rng.permutation(256),
                               -1) for _ in range(14)])
    state = stage_state(d, row, col, np.maximum(row.max(axis=1),
                                                 col.max(axis=1)), match, dev)
    out["bna_step B=14 w=256"] = _cuda_ms(lambda: bna_step(*state))
    for K in (5277, 119288):
        delta = torch.as_tensor(rng.integers(-3, 4, size=(K, 300)),
                                dtype=torch.int32, device=dev)
        out[f"coflow_merge K={K}"] = _cuda_ms(lambda: coflow_merge(delta))
    for n_times, E in ((7734, 267_537), (10_000_000, 60_000)):
        t0 = rng.integers(0, n_times, E)
        t1 = t0 + rng.integers(1, 5_000, E)
        args = [torch.as_tensor(a, dtype=torch.int64, device=dev) for a in (
            np.unique(np.concatenate([t0, t1])), t0, t1,
            rng.integers(0, 150, E), rng.integers(0, 150, E))]
        K = args[0].numel() - 1
        out[f"merge_fix K={K} E={E}"] = _cuda_ms(lambda: merge_fix(*args, 150))
    orig_mf = backend.merge_fix_step
    for sched in ("gdm", "om_alg"):
        largest: dict = {}

        def keep_merge(events, t0, t1, s, r, m, *, device):
            if events.size > largest.get("K", 0):
                largest.update(K=events.size, args=(events, t0, t1, s, r),
                               m=m)
            return orig_mf(events, t0, t1, s, r, m, device=device)

        backend.merge_fix_step = keep_merge
        try:
            clear_caches()
            plan(paper_workload(m=150, mu_bar=5, seed=0, scale=1.0), sched,
                 device="cuda", plan_backend="pipeline", seed=0)
        finally:
            backend.merge_fix_step = orig_mf
        args = [torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64),
                                device=dev) for a in largest["args"]]
        out[f"merge_fix K={args[0].numel() - 1} E={args[1].numel()} "
            f"({sched} at 1.0)"] = _cuda_ms(
                lambda: merge_fix(*args, largest["m"]))
        del args
    widest: dict = {}
    orig = pipeline.bna_decompose

    def keep(d, ks, T_cap, t_store=None):
        if d.shape[0] * d.shape[1] > widest.get("size", 0):
            widest.update(size=d.shape[0] * d.shape[1],
                          args=(d, ks, T_cap, t_store))
        return orig(d, ks, T_cap, t_store=t_store)

    pipeline.bna_decompose = keep
    try:
        clear_caches()
        plan(paper_workload(m=150, mu_bar=5, seed=0, scale=0.25), "gdm",
             device="cuda", plan_backend="pipeline", seed=0)
    finally:
        pipeline.bna_decompose = orig
    d, ks, T_cap, t_store = widest["args"]
    out[f"bna_decompose B={d.shape[0]} w={d.shape[1]}"] = _wall_ms(
        lambda: bna_decompose(d, ks, T_cap, t_store=t_store), rounds=5)
    inst_rt = paper_workload(m=150, mu_bar=5, seed=0, scale=0.1, rooted=True)

    def plan_rt():
        clear_caches()
        plan(inst_rt, "gdm_rt", device="cuda", plan_backend="pipeline",
             seed=0)

    out["plan gdm_rt scale=0.1 pipeline (wall)"] = _wall_ms(plan_rt)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--time"]:
        print(json.dumps(time_root(Path(sys.argv[2]).resolve())))
        return 0
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    roots = {"A": Path(sys.argv[1]).resolve(),
             "B": Path(sys.argv[2] if len(sys.argv) > 2
                       else Path(__file__).resolve().parents[1]).resolve()}
    turns = []
    for name in ("A", "B", "B", "A"):
        r = subprocess.run([sys.executable, __file__, "--time",
                            str(roots[name])], capture_output=True,
                           text=True, timeout=1200)
        if r.returncode != 0:
            print(r.stdout, r.stderr, file=sys.stderr)
            return 1
        times = json.loads(r.stdout.strip().splitlines()[-1])
        turns.append((name, times))
        print(f"{name} ({roots[name]}): {json.dumps(times)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    summary = {}
    for key in turns[0][1]:
        med = {n: statistics.median(t[key] for m, t in turns if m == n)
               for n in ("A", "B")}
        summary[key] = {"A_ms": med["A"], "B_ms": med["B"],
                        "B_over_A": med["B"] / med["A"]}
    print(smi)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())

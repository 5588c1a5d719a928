"""Training launcher, the port of ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --smoke --steps 50 --ckpt-dir build/ckpt --device cpu

``--device`` defaults to ``cuda``: on a card every attention of the step
runs the flash_attention kernel (K4) forward and backward, and every
mamba layer the ssd_scan kernel (K5) forward and backward, so mamba2-2.7b
and the hybrids (jamba) train on the card as the dense LMs do.  ``--smoke``
trains the reduced same-family config; a full-size config of another
family than the decoder-only LMs is refused, as the reference refuses it.
The run resumes from the newest checkpoint under ``--ckpt-dir``.

--plan-buckets N wires the coflow planner end to end: the model's gradient
leaves become leaf-size-calibrated all-reduce collectives, bucketed into N
jobs, planned on a live SchedulerSession (``repro_torch.dist.planner.plan``,
on the run's device), and the planned permutation is the order in which
the train step walks its gradient buckets (``build_train_step(
bucket_order=...)``), where a data-parallel run issues their all-reduces:
numerically neutral by construction.  Prints a JSON summary with the
reference's keys.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from ..configs import get_config
from ..data.pipeline import DataConfig
from ..ft import FTConfig, TrainRunner
from ..models.lm import tree_leaves
from ..train.optim import OptConfig
from ..train.step import leaf_paths

__all__ = ["planned_bucket_order", "main"]


def planned_bucket_order(cfg, n_buckets: int, rows: int = 2, cols: int = 4,
                         seed: int = 0, device="cuda"):
    """Gradient-bucket launch order from the coflow planner.

    Builds one all-reduce CollectiveOp per gradient leaf (payload = the
    leaf's elements x 4 bytes), leaves in the reference's order (sorted
    keys, so the ops' indices and the planned order are the reference's),
    buckets them into `n_buckets` chained jobs on the rows x cols abstract
    fabric, plans the phase against a live SchedulerSession on `device`,
    and translates the planned job permutation back into bucket lists of
    leaf paths for ``build_train_step(bucket_order=...)``.

    Returns (bucket_order, PlanOutcome)."""
    from ..dist.planner import (CollectiveOp, bucket_order_from_plan,
                                coflows_from_step, plan)
    from .specs import abstract_params

    params = abstract_params(cfg)
    paths = leaf_paths(params)
    ops = [CollectiveOp("all-reduce", float(int(np.prod(leaf.shape)) * 4),
                        i, "data")
           for i, leaf in enumerate(tree_leaves(params))]
    n_buckets = max(1, min(int(n_buckets), len(ops)))
    inst = coflows_from_step(ops, rows=rows, cols=cols, n_buckets=n_buckets)
    outcome = plan(inst, seed=seed, device=device)
    return bucket_order_from_plan(outcome, paths), outcome


def main(argv: "list[str] | None" = None) -> dict:
    """Parse `argv` (the command line by default), train, print the
    summary; returns it with the runner, the final state, the planner's
    outcome and its wall seconds."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="train the reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plan-buckets", type=int, default=0,
                    help="bucket gradients into N jobs and walk them in the "
                         "coflow planner's order (0 disables)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if cfg.family != "lm" and not args.smoke:
        raise SystemExit("full-size non-LM training needs accelerators; use "
                         "--smoke")

    bucket_order, outcome, plan_s = (None, None, 0.0)
    if args.plan_buckets > 0:
        t0 = time.perf_counter()
        bucket_order, outcome = planned_bucket_order(
            cfg, args.plan_buckets, seed=args.seed, device=args.device)
        plan_s = time.perf_counter() - t0

    runner = TrainRunner(
        cfg,
        OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                  total_steps=args.steps),
        DataConfig(seq_len=args.seq_len, global_batch=args.global_batch,
                   seed=args.seed),
        FTConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
        seed=args.seed, bucket_order=bucket_order, device=args.device)
    state = runner.run(args.steps)
    log = runner.metrics_log
    summary = {
        "arch": cfg.name, "steps": len(log),
        "first_loss": log[0]["loss"] if log else float("nan"),
        "last_loss": log[-1]["loss"] if log else float("nan"),
        "stragglers": len(runner.monitor.flagged),
    }
    if outcome is not None:
        summary["planned_buckets"] = len(outcome.order)
        summary["bucket_order"] = outcome.order
        summary["bucket_makespan_gain_pct"] = round(
            100 * outcome.makespan_gain, 1)
    print(json.dumps(summary))
    return {"summary": summary, "runner": runner, "state": state,
            "outcome": outcome, "plan_s": plan_s}


if __name__ == "__main__":
    main()

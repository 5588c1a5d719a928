#!/usr/bin/env python3
"""Split the wall of backfilled plans (the ``*_bf`` schedulers) of
``paper_workload(m=150, mu_bar=5, seed=0, scale)`` into the plan, the
prefetch, merge_and_fix's fix-up (its walk, batch and emission; in the
batch the ``bna_decompose`` device time, ``_steps_to_lists`` and the
staging), the packet sweep and the rest, with ``chip_smoke.py``'s phase 6c
instrumentation (``chip_smoke._bf_plan``, which also checks each run).

    python3 scripts/bf_split.py [--device cuda|cpu] [--plan-backend
        pipeline|python] [--exec packet|ledger] SCHED:SCALE [...]

e.g. ``python3 scripts/bf_split.py gdm_bf:0.1 gdm_bf:0.35 gdm_rt_bf:0.25``.
Runs one after another in this process, printing each as it ends (one JSON
line, with the card's name and power limit first on a card) and writing
them all to ``chiprun_out/bf_split.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import _bf_plan  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("runs", nargs="+", metavar="SCHED:SCALE")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--plan-backend", default="pipeline",
                    choices=("pipeline", "python"))
    ap.add_argument("--exec", default="packet", choices=("packet", "ledger"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    out = []
    for spec in args.runs:
        sched, scale = spec.split(":")
        job = (sched, args.exec, float(scale), args.device,
               args.plan_backend)
        t0 = time.perf_counter()
        run = _bf_plan(job)
        row = {k: run[k] for k in (
            "job", "coflows", "twct", "plan_twct", "makespan", "entries",
            "split", "fixup", "launches", "host_repairs", "scalar_bna",
            "verify_s")}
        row["total_s"] = time.perf_counter() - t0
        out.append(row)
        print(json.dumps(row), flush=True)
        (ROOT / "chiprun_out").mkdir(exist_ok=True)
        (ROOT / "chiprun_out" / "bf_split.json").write_text(
            json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

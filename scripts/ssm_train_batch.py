#!/usr/bin/env python3
"""Does mamba2-2.7b train at full width on one card at a larger batch?
The reading behind ``chip_smoke.py`` phase 16(d)'s ``SSM_TRAIN_BATCH``.

    python3 scripts/ssm_train_batch.py [BATCH ...]     # one CUDA card

For each global batch (default 8), of 4096 tokens a row, trains
mamba2-2.7b (seed 0, bf16, remat "full") through
``repro_torch.launch.train``'s ``main`` for 4 steps with ``--plan-buckets
8``, as phase 16(d) does (its ``_train_full_width``, which checks the
losses, the grad norms and K5's launches a step), and prints one JSON
line: step seconds (median of steps 2-4), tokens/s, peak memory, losses
and grad norms; or, where the batch does not fit, the out-of-memory error
and the memory allocated when it was raised.  The first line is the
card's name and power limit.
"""
from __future__ import annotations

import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ssm_train_batch: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels.bna_decompose import bna_decompose
    from repro_torch.kernels.merge_fix import merge_fix
    from repro_torch.kernels.ssd_scan import (ssd_bwd_chunk, ssd_bwd_state,
                                              ssd_scan)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs._nvidia_smi())
    kernels.build_kernels(list(cs.KERNELS))
    wrappers = {"bna_decompose": bna_decompose, "merge_fix": merge_fix,
                "ssd_scan": ssd_scan, "ssd_bwd_state": ssd_bwd_state,
                "ssd_bwd_chunk": ssd_bwd_chunk}

    def zero_counts() -> None:
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts() -> dict:
        return {name: fn.launches for name, fn in wrappers.items()}

    cfg = get_config(cs.SSM_ARCH)
    per_step = {"ssd_scan": 2 * cfg.n_layers,           # remat "full"
                **{k: cfg.n_layers for k in cs.SSD_BWD}}
    dev = torch.device("cuda")
    for batch in [int(b) for b in sys.argv[1:]] or [8]:
        row: dict = {"arch": cfg.name, "global_batch": batch,
                     "seq_len": cs.SSM_TRAIN_SEQ}
        try:
            _, rec = cs._train_full_width(
                dev, (zero_counts, read_counts), cs.SSM_ARCH,
                cs.SSM_TRAIN_STEPS, cs.SSM_TRAIN_SEQ, batch, per_step)
            row.update(fits=True, **{k: rec[k] for k in (
                "step_s", "step_s_median_2_4", "tokens_per_s", "loss",
                "grad_norm", "max_memory_allocated", "launches_per_step")})
        except torch.cuda.OutOfMemoryError as err:
            row.update(fits=False, error=str(err).splitlines()[0],
                       memory_allocated=torch.cuda.memory_allocated(),
                       max_memory_allocated=torch.cuda.max_memory_allocated())
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())

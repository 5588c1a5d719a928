#!/usr/bin/env python3
"""How far K4's bf16 forward (``flash_attention``) lies from its plain
version (``attention_ref``), by the three measures ``chip_smoke.py`` holds
it to: the largest |difference| (``ATTN_TOL``) and, on the wgmma route
(d = 64 and 128), the difference relative to the output's own size
(``attn_rel_err``: per query row against the row's largest |value|, per
(batch, head) in L2; ``WGMMA_REL_TOL``).

The shapes are phase 7's at d = 64 and 128 (qwen3-1.7b's prefill at S =
2048, the families' of ``FAMILY_ATTN``) and the card tests' (GQA ratios 1
to 16, Sq != Sk, lengths off the tiles), each causal and not, bf16 inputs
drawn from a normal distribution with a fixed seed.  Prints one JSON line
per case, then the largest of each measure beside its limit and the card's
name and power limit, and exits 1 if any case is past a limit.

    python3 scripts/attn_fwd_error.py

One card, under a minute.  It measures the kernels of the checkout it is
in, so a modified copy of the repository measures its own.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (ATTN_TOL, FAMILY_ATTN, WGMMA_REL_TOL,  # noqa: E402
                        attn_rel_err)

SHAPES = [(1, 16, 8, 2048, 2048, 128), (1, 4, 4, 48, 48, 128),
          (1, 4, 1, 1, 96, 64), *FAMILY_ATTN,
          (1, 4, 4, 77, 77, 64), (2, 8, 4, 130, 130, 128),
          (1, 6, 2, 300, 100, 64), (1, 6, 2, 100, 300, 128),
          (1, 8, 2, 257, 257, 64), (1, 32, 2, 129, 129, 128),
          (1, 16, 1, 64, 1500, 64)]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("attn_fwd_error: no CUDA card available", file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     forward_kernel)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    dev = torch.device("cuda")
    worst = {"abs": 0.0, "row": 0.0, "head": 0.0}
    rng = np.random.default_rng(7)
    for shape in SHAPES:
        B, Hq, Hkv, Sq, Sk, d = shape
        q, k, v = (torch.as_tensor(rng.normal(size=s), dtype=torch.bfloat16,
                                   device=dev)
                   for s in ((B, Hq, Sq, d), (B, Hkv, Sk, d),
                             (B, Hkv, Sk, d)))
        for causal in (True, False):
            got = flash_attention(q, k, v, causal=causal)
            want = attention_ref(q, k, v, causal=causal)
            # rows that see no key (causal, Sq > Sk): the plain version's
            # NaN, left out here as in chip_smoke
            sees = torch.isfinite(want.float()).all(-1)
            err = float((got.float() - want.float())[sees].abs().max())
            rel = attn_rel_err(got, want)
            row = {"shape": list(shape), "causal": causal,
                   "route": forward_kernel(q.dtype, d), "abs": err, **rel}
            print(json.dumps(row))
            for key in worst:
                worst[key] = max(worst[key], row[key])
    limits = {"abs": ATTN_TOL["bfloat16"], **WGMMA_REL_TOL}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    past = {k: worst[k] for k in worst if not worst[k] <= limits[k]}
    print(json.dumps({"worst": worst, "limits": limits, "past": past}))
    return 1 if past else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""How far mamba2-2.7b's teacher-forcing logits drift in bf16, sound and with
planted faults: the readings behind ``chip_smoke.py``'s bf16 limit.

    python3 scripts/mamba2_bf16_drift.py      # one CUDA card

Full-width weights from seed 0 and the 80 tokens of ``chip_smoke.py``
phase 12: prefill 64 tokens (the chunked form), decode 16 (the recurrence),
and compare their logits with ``lm_forward``'s (K5) at the same positions,
as max |diff| over the largest logit.  Variants, each patched in at run
time and removed after:

- ``sound``: the port as it is (also with float32 copies of the weights);
- ``plain_scan``: ``lm_forward``'s K5 swapped for ``ssd_ref``;
- ``decode_state_bf16``: decode rounds the state h to bf16 each step;
- ``decode_decay_bf16``: decode rounds the decay a to bf16;
- ``prefill_state_bf16``: prefill hands decode its state rounded to bf16;
- ``decode_state_dropped``: decode never updates h.

The first two are sound; the last four are faults, the first three of which
show only in bf16.  Prints one JSON line.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mamba2_bf16_drift: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan.ref import ssd_ref
    from repro_torch.models import (decode_step, init_lm, lm_forward,
                                    prefill, ssm)
    from repro_torch.models.lm import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("mamba2-2.7b")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0))
    P_tf, D_tf, V = 64, 16, cfg.vocab
    toks = torch.as_tensor(np.random.default_rng(12).integers(
        1, V, size=(1, P_tf + D_tf)), device=dev)

    def teacher_forcing(p) -> dict:
        with torch.inference_mode():
            full = lm_forward(cfg, p, toks)[0][0, :, :V].float()
            lg, cache = prefill(cfg, p, toks[:, :P_tf])
            steps = [lg[0].float()]
            for t in range(P_tf, P_tf + D_tf):
                lg, cache = decode_step(cfg, p, cache, toks[:, t:t + 1])
                steps.append(lg[0].float())
        steps = torch.stack(steps)
        want = full[P_tf - 1:P_tf + D_tf]
        diff, top = float((steps - want).abs().max()), float(want.abs().max())
        return {"max_abs_diff": diff, "max_abs_logit": top,
                "share": diff / top,
                "argmax_agree": int((steps.argmax(-1)
                                     == want.argmax(-1)).sum()),
                "positions": len(steps)}

    step, chunked = ssm.ssd_decode_step, ssm._ssd_chunked

    def state_bf16(h, x, a, b, c):
        h, y = step(h, x, a, b, c)
        return h.to(x.dtype).float(), y

    def decay_bf16(h, x, a, b, c):
        return step(h, x, a.to(x.dtype).float(), b, c)

    def state_dropped(h, x, a, b, c):
        return h, step(h, x, a, b, c)[1]

    def prefill_bf16(x, a, b, c, chunk):
        y, h = chunked(x, a, b, c, chunk)
        return y, h.to(x.dtype).float()

    variants = {
        "sound": {},
        "plain_scan": {"ssd_scan": lambda x, a, b, c, *, chunk=128:
                       ssd_ref(x, a, b, c)},
        "decode_state_bf16": {"ssd_decode_step": state_bf16},
        "decode_decay_bf16": {"ssd_decode_step": decay_bf16},
        "prefill_state_bf16": {"_ssd_chunked": prefill_bf16},
        "decode_state_dropped": {"ssd_decode_step": state_dropped},
    }
    out = {"float32": {"sound": teacher_forcing(
        tree_map(lambda x: x.float(), params))}, "bfloat16": {}}
    torch.cuda.empty_cache()
    for name, patch in variants.items():
        saved = {k: getattr(ssm, k) for k in patch}
        for k, fn in patch.items():
            setattr(ssm, k, fn)
        try:
            out["bfloat16"][name] = teacher_forcing(params)
        finally:
            for k, fn in saved.items():
                setattr(ssm, k, fn)
        print(f"{name}: {json.dumps(out['bfloat16'][name])}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

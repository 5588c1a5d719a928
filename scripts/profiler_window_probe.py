#!/usr/bin/env python3
"""Does ``torch.profiler`` record every K5 launch of a profiled full-width
mamba2-2.7b ``lm_forward``?  The reading behind ``chip_smoke.py`` phase
11's spin kernels.

    python3 scripts/profiler_window_probe.py      # one CUDA card

Full-width weights from seed 0, B = 2, S = 4096 (phase 11's pass).  The
pass is profiled in a fresh process, then after two profiled qwen3-1.7b
prefills (phase 8's profile) and after a window of 20,000 small kernels.
Each reading prints the ``ssd_scan`` calls counted by the wrapper, the
profiler's CUDA events of each of K5's three kernels (they must equal the
calls), all CUDA events, and the first K5 event's offset from the first
event.  ``chip_smoke.py``, 15 minutes into its process, saw one call's
three kernels missing twice, and with a 10 ms spin kernel first, the spin
and the 44 kernels after it; a fresh process saw none missing.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profiler_window_probe: no CUDA card available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import K5_NAMES
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import init_lm, lm_forward, prefill

    kernels.build_kernels(["ssd_scan", "flash_attention"])
    dev = torch.device("cuda")
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    cfg = get_config("mamba2-2.7b")
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        1, cfg.vocab, size=(2, 4096)), device=dev)
    readings = []

    def mamba(label: str) -> None:
        with torch.inference_mode():
            ssd_scan.launches = 0
            torch.cuda.synchronize()
            with profile(activities=activities) as prof:
                lm_forward(cfg, params, toks)
                torch.cuda.synchronize()
        ev = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
        k5 = [e.time_range.start for e in ev if K5_NAMES[0] in e.name]
        readings.append({
            "after": label, "calls": ssd_scan.launches,
            "by_kernel": {n: sum(n in e.name for e in ev)
                          for n in K5_NAMES},
            "cuda_events": len(ev),
            "first_k5_offset_us": k5[0] - ev[0].time_range.start
            if k5 else None})
        print(json.dumps(readings[-1]), flush=True)

    with torch.inference_mode():
        lm_forward(cfg, params, toks)
        torch.cuda.synchronize()
    mamba("a fresh process")
    qcfg = get_config("qwen3-1.7b")
    qparams = init_lm(qcfg, torch.Generator(device=dev).manual_seed(0))
    qtoks = torch.as_tensor(np.random.default_rng(3).integers(
        1, qcfg.vocab, size=(1, 2852)), device=dev)
    with torch.inference_mode():
        for _ in range(2):
            with profile(activities=activities):
                prefill(qcfg, qparams, qtoks)
                torch.cuda.synchronize()
    del qparams
    mamba("two profiled qwen3 prefills")
    with profile(activities=activities):
        x = torch.ones(10, device=dev)
        for _ in range(20000):
            x = x + 1
        torch.cuda.synchronize()
    mamba("a window of 20000 small kernels")
    smi = __import__("chip_smoke")._nvidia_smi()
    print(smi)
    print(json.dumps({"readings": readings, "card": smi,
                      "torch": torch.__version__}))
    lost = [r for r in readings
            if any(c != r["calls"] for c in r["by_kernel"].values())]
    return 1 if lost else 0


if __name__ == "__main__":
    sys.exit(main())

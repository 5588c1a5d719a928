#!/usr/bin/env python3
"""Time K5's backward wrappers of two checkouts of this repository on one
card, in turns (A, B, B, A), bf16, at mamba2-2.7b's training shape (B=4,
S=4096, H=80, G=1, N=128, P=64, L=128) and at jamba-1.5-large's full-width
heads (B=1, S=4096, H=256, G=8):

- ``ssd_bwd_state`` (the chunk state gradients) and ``ssd_bwd_chunk``
  (dx, da, db and dc) (CUDA events, chip_smoke's ``_cuda_ms``) and their
  sum, a layer's backward;
- each CUDA kernel the two wrappers launch, by name: its device time a
  call under ``torch.profiler`` (the FMA route's chunk kernel against its
  reverse pass and group sum, the tensor-core route's kernels as they
  are), in the turn's ``launches`` entry, which the summary leaves out as
  the two roots' kernels differ;
- each root's two wrappers run twice on the same inputs: same bits or not.

    python3 scripts/ssd_bwd_ab.py A_ROOT [B_ROOT]
    python3 scripts/ssd_bwd_ab.py --bytes

``--bytes`` prints, with no card, the device bytes each wrapper's kernels
name in their loads and stores at SHAPES (``moved_bytes``), beside the
bytes its bound counts.

B_ROOT defaults to this checkout.  Each turn runs in its own process with
``A_ROOT/src`` or ``B_ROOT/src`` on the path, so each builds and loads its
own kernels.  Inputs come from fixed seeds and are the same in every turn.
Prints each turn's times and, per wrapper and shape, the median of each
root's two turns and their ratio, beside the card's name and power limit.
"""
from __future__ import annotations

import json
import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from attn_bwd_ab import run_turns  # noqa: E402
from chip_smoke import _cuda_ms  # noqa: E402

SHAPES = ((4, 4096, 80, 1, 128, 64, 128), (1, 4096, 256, 8, 128, 64, 128))
PROFILED_CALLS = 3


def moved_bytes(B, S, H, G, N, P, L) -> dict:
    """Device bytes each backward wrapper's kernels name in their loads and
    stores at a bf16 shape, every kernel's own (what its blocks share
    through L2 is counted once a kernel): ``tensor_cores`` the bf16
    kernels of csrc/ssd_scan_bwd_mma.cu (the state walk; the dx, db and dc
    role kernels, x and dy each, G or h, and the finish), ``fma`` the
    float32-FMA kernels that ran bf16 before them (U written and read back
    by the reverse pass; per-head partials of db and dc), the figure
    PERF.md's kernel table gives for the earlier design."""
    rows, nC = B * S, S // L
    x = rows * H * P * 2                  # x, dy, dx (bf16)
    bc = rows * G * N * 2                 # b, c, db, dc (bf16)
    la = rows * H * 4                     # a, loga, da, dla parts (float32)
    st = B * nC * H * N * P * 4           # states, G, U (float32)
    dec = B * nC * H * 4
    part = rows * G * -(-(H // G) // 8) * N * 4   # a slice's db or dc
    head = rows * H * N * 4               # a head's db or dc
    return {
        "tensor_cores": {
            "ssd_bwd_state": bc + x + la + dec + st,
            "ssd_bwd_chunk": (2 * x + 2 * st + 2 * bc + la)      # dx role
            + (2 * x + st + bc + la)                            # db role
            + (2 * x + st + 2 * bc + la)                        # dc role
            + x + 2 * la + 2 * part                             # written
            + 2 * part + 3 * la + 2 * bc + la},                 # finish
        "fma": {
            "ssd_bwd_state": (bc + x + la + st) + (2 * st + dec),
            "ssd_bwd_chunk": (2 * x + 2 * bc + 2 * la + 2 * st)
            + x + la + 2 * head + 2 * head + 2 * bc}}


def kernel_ms(fns) -> dict:
    """Device ms a call of each CUDA kernel that ``fns`` launch (each fn
    called PROFILED_CALLS times under torch.profiler), by kernel name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        name = re.search(r"ssd_\w+(<[^>]*>)?", e.key)
        if us and name:
            out[name.group(0)] = us / PROFILED_CALLS / 1e3
    return out


def time_root(root: Path) -> dict:
    """One turn: this root's backward wrappers at SHAPES (ms)."""
    import torch

    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels.ssd_scan import ssd_bwd_chunk, ssd_bwd_state
    from repro_torch.kernels.ssd_scan.ops import _forward

    dev = torch.device("cuda")
    out = {}
    for B, S, H, G, N, P, L in SHAPES:
        g = torch.Generator(device=dev).manual_seed(S + H)
        x = torch.randn((B, S, H, P), generator=g, device=dev).bfloat16()
        a = torch.rand((B, S, H), generator=g, device=dev) * 0.45 + 0.55
        bc = (torch.randn((B, S, 2, G, N), generator=g, device=dev)
              * 0.3).bfloat16()
        b, c = bc[:, :, 0], bc[:, :, 1]
        dy = torch.randn((B, S, H, P), generator=g, device=dev).bfloat16()
        with torch.no_grad():
            loga, states, decay = _forward(x, a, b, c, L, True)[1]
        grads = ssd_bwd_state(c, dy, loga, decay, chunk=L)
        tag = f"B={B} H={H} G={G}"

        def state():
            return ssd_bwd_state(c, dy, loga, decay, chunk=L)

        def chunk():
            return ssd_bwd_chunk(x, a, loga, b, c, dy, states, grads,
                                 chunk=L)

        times = {"ssd_bwd_state": _cuda_ms(state, reps=5, rounds=3),
                 "ssd_bwd_chunk": _cuda_ms(chunk, reps=3, rounds=3)}
        times["whole"] = sum(times.values())
        for name, t in times.items():
            out[f"{name} {tag}"] = t
        out.setdefault("launches", {})[tag] = {
            "ssd_bwd_state": kernel_ms([state]),
            "ssd_bwd_chunk": kernel_ms([chunk])}
        same = all(torch.equal(u, v) for u, v in zip(
            (state(), *chunk()), (state(), *chunk())))
        out[f"same_bits {tag}"] = float(same)
        del x, a, bc, b, c, dy, loga, states, decay, grads
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if sys.argv[1:2] == ["--bytes"]:
        from chip_smoke import ssd_bwd_bounds
        for shape in SHAPES:
            bounds = ssd_bwd_bounds(*shape)
            print(json.dumps({"shape": shape, **moved_bytes(*shape),
                              "bound_bytes": {k: v["bytes"]
                                              for k, v in bounds.items()}}))
        return 0
    if sys.argv[1:2] == ["--time"]:
        print(json.dumps(time_root(Path(sys.argv[2]).resolve())))
        return 0
    return run_turns(__file__, __doc__)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time K5's backward wrappers of two checkouts of this repository on one
card, in turns (A, B, B, A), bf16, at mamba2-2.7b's training shape (B=4,
S=4096, H=80, G=1, N=128, P=64, L=128) and at jamba-1.5-large's full-width
heads (B=1, S=4096, H=256, G=8):

- ``ssd_bwd_state`` (the chunk state gradients and the reverse pass) and
  ``ssd_bwd_chunk`` (the chunk gradients and the group sum) (CUDA events,
  chip_smoke's ``_cuda_ms``) and their sum, a layer's backward;
- each root's two wrappers run twice on the same inputs: same bits or not.

    python3 scripts/ssd_bwd_ab.py A_ROOT [B_ROOT]

B_ROOT defaults to this checkout.  Each turn runs in its own process with
``A_ROOT/src`` or ``B_ROOT/src`` on the path, so each builds and loads its
own kernels.  Inputs come from fixed seeds and are the same in every turn.
Prints each turn's times and, per wrapper and shape, the median of each
root's two turns and their ratio, beside the card's name and power limit.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from attn_bwd_ab import run_turns  # noqa: E402
from chip_smoke import _cuda_ms  # noqa: E402

SHAPES = ((4, 4096, 80, 1, 128, 64, 128), (1, 4096, 256, 8, 128, 64, 128))


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
        same = all(torch.equal(u, v) for u, v in zip(
            (state(), *chunk()), (state(), *chunk())))
        out[f"same_bits {tag}"] = float(same)
        del x, a, bc, b, c, dy, loga, states, decay, grads
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if sys.argv[1:2] == ["--time"]:
        print(json.dumps(time_root(Path(sys.argv[2]).resolve())))
        return 0
    return run_turns(__file__, __doc__)


if __name__ == "__main__":
    sys.exit(main())

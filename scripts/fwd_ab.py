#!/usr/bin/env python3
"""Time the forwards of K4 (``flash_attention``) and K5 (``ssd_scan``) of
two checkouts of this repository on one card, in turns (A, B, B, A), bf16:

- K4, causal, at qwen3-1.7b's largest prefill (B=1, Hq=16, Hkv=8, S=2852,
  d=128) without lse, at its training shape (B=4, S=4096) with lse
  (``flash_attention_lse``, the training forward), and at the families'
  shapes (chip_smoke's ``FAMILY_ATTN``, causal or not as their paths run
  them), each beside ``scaled_dot_product_attention`` on the same inputs
  (the yardstick; the port never calls it);
- K5 at mamba2-2.7b's serving shape (B=2, S=4096, H=80, G=1, N=128, P=64,
  L=128) keeping nothing, and at its training shape (B=4) keeping the
  states (``ops._forward(..., keep=True)``, what the training forward
  runs);
- each root's forwards run twice on the same inputs: same bits or not;
- each time's bound (chip_smoke's ``attn_fwd_bounds``, ``ssd_fwd_bounds``).

    python3 scripts/fwd_ab.py A_ROOT [B_ROOT]

B_ROOT defaults to this checkout.  Each turn runs in its own process with
``A_ROOT/src`` or ``B_ROOT/src`` on the path, so each builds and loads its
own kernels.  Inputs come from fixed seeds and are the same in every turn.
Prints each turn's times and, per key, the median of each root's two turns
and their ratio, beside the card's name and power limit.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from attn_bwd_ab import run_turns  # noqa: E402
from chip_smoke import (FAMILY_ATTN, _cuda_ms, attn_fwd_bounds,  # noqa: E402
                        ssd_fwd_bounds)

# (B, Hq, Hkv, Sq, Sk, d) -> (causal, with lse)
ATTN = {(1, 16, 8, 2852, 2852, 128): (True, False),
        (4, 16, 8, 4096, 4096, 128): (True, True),
        **{shape: (causal, False) for shape, causal in FAMILY_ATTN.items()}}
# (B, S, H, G, N, P, L) -> keep the states
SSD = {(2, 4096, 80, 1, 128, 64, 128): False,
       (4, 4096, 80, 1, 128, 64, 128): True}


def time_root(root: Path) -> dict:
    """One turn: this root's K4 and K5 forwards at ATTN and SSD (ms), SDPA
    beside K4, and whether two runs give the same bits."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_lse)
    from repro_torch.kernels.ssd_scan.ops import _forward as ssd_forward

    dev = torch.device("cuda")
    out = {}
    for shape, (causal, lse) in ATTN.items():
        B, Hq, Hkv, Sq, Sk, d = shape
        g = torch.Generator(device=dev).manual_seed(Sq + Sk)
        q, k, v = (torch.randn(sz, generator=g, device=dev)
                   .to(torch.bfloat16)
                   for sz in ((B, Hq, Sq, d), (B, Hkv, Sk, d),
                              (B, Hkv, Sk, d)))
        sc = d ** -0.5
        tag = (f"K4 B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Sk={Sk} d={d} "
               f"causal={causal}{' lse' if lse else ''}")

        def k4():
            if lse:
                return flash_attention_lse(q, k, v, causal=causal, scale=sc)
            return (flash_attention(q, k, v, causal=causal, scale=sc),)

        out[tag] = _cuda_ms(k4, reps=10, rounds=3)
        # SDPA aligns its causal mask to the top left: timed where Sq = Sk
        if not causal or Sq == Sk:
            out[f"SDPA {tag}"] = _cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, scale=sc, enable_gqa=True),
                reps=10, rounds=3)
        out[f"bound {tag}"] = attn_fwd_bounds(B, Hq, Hkv, Sq, Sk, d, causal,
                                              lse=lse)["bound_ms"]
        out[f"same_bits {tag}"] = float(all(
            torch.equal(a, b) for a, b in zip(k4(), k4())))
        del q, k, v
        torch.cuda.empty_cache()
    for shape, keep in SSD.items():
        B, S, H, G, N, P, L = shape
        r = np.random.default_rng(5)
        x = torch.as_tensor(r.normal(size=(B, S, H, P)),
                            dtype=torch.bfloat16, device=dev)
        a = torch.as_tensor(r.uniform(0.55, 1.0, size=(B, S, H)),
                            dtype=torch.float32, device=dev)
        b, c = (torch.as_tensor(r.normal(size=(B, S, G, N)) * 0.3,
                                dtype=torch.bfloat16, device=dev)
                for _ in range(2))
        tag = f"K5 B={B} S={S} H={H} keep={keep}"

        def k5():
            y, kept = ssd_forward(x, a, b, c, L, keep)
            return (y, *kept)

        out[tag] = _cuda_ms(k5, reps=10, rounds=3)
        out[f"bound {tag}"] = ssd_fwd_bounds(*shape, keep=keep)["bound_ms"]
        out[f"same_bits {tag}"] = float(all(
            torch.equal(u, w) for u, w in zip(k5(), k5())))
        del x, a, b, c
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if sys.argv[1:2] == ["--time"]:
        print(json.dumps(time_root(Path(sys.argv[2]).resolve())))
        return 0
    return run_turns(__file__, __doc__)


if __name__ == "__main__":
    sys.exit(main())

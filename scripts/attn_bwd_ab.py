#!/usr/bin/env python3
"""Time K4's backward kernels of two checkouts of this repository on one
card, in turns (A, B, B, A), bf16 and causal, at qwen3-1.7b's training shape
(B=4, Hq=16, Hkv=8, S=4096, d=128) and at granite-moe-3b's head shape
(B=1, Hq=24, Hkv=8, S=3072, d=64):

- ``attn_bwd_prep``, ``attn_bwd_dkdv`` and ``attn_bwd_dq`` (CUDA events,
  chip_smoke's ``_cuda_ms``) and their sum, the whole backward;
- each root's dkdv and dq run twice on the same inputs: same bits or not.

    python3 scripts/attn_bwd_ab.py A_ROOT [B_ROOT]

B_ROOT defaults to this checkout.  Each turn runs in its own process with
``A_ROOT/src`` or ``B_ROOT/src`` on the path, so each builds and loads its
own kernels.  Inputs come from fixed seeds and are the same in every turn.
Prints each turn's times and, per kernel and shape, the median of each
root's two turns and their ratio, beside the card's name and power limit.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import _cuda_ms  # noqa: E402

SHAPES = ((4, 16, 8, 4096, 128), (1, 24, 8, 3072, 64))


def time_root(root: Path) -> dict:
    """One turn: this root's backward kernels at SHAPES (ms)."""
    import torch

    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels.flash_attention import (attn_bwd_dkdv,
                                                     attn_bwd_dq,
                                                     attn_bwd_prep,
                                                     flash_attention_lse)

    dev = torch.device("cuda")
    out = {}
    for B, Hq, Hkv, S, d in SHAPES:
        g = torch.Generator(device=dev).manual_seed(S)
        q, k, v, do = (torch.randn(sz, generator=g, device=dev)
                       .to(torch.bfloat16)
                       for sz in ((B, Hq, S, d), (B, Hkv, S, d),
                                  (B, Hkv, S, d), (B, Hq, S, d)))
        sc = d ** -0.5
        o, lse = flash_attention_lse(q, k, v, scale=sc)
        D = attn_bwd_prep(o, do)
        tag = f"B={B} S={S} d={d}"

        def dkdv():
            return attn_bwd_dkdv(q, k, v, do, lse, D, causal=True, scale=sc)

        def dq():
            return attn_bwd_dq(q, k, v, do, lse, D, causal=True, scale=sc)

        times = {"attn_bwd_prep": _cuda_ms(lambda: attn_bwd_prep(o, do),
                                           reps=5, rounds=3),
                 "attn_bwd_dkdv": _cuda_ms(dkdv, reps=5, rounds=3),
                 "attn_bwd_dq": _cuda_ms(dq, reps=5, rounds=3)}
        times["whole"] = sum(times.values())
        for name, t in times.items():
            out[f"{name} {tag}"] = t
        same = all(torch.equal(a, b) for a, b in zip(
            (*dkdv(), dq()), (*dkdv(), dq())))
        out[f"same_bits {tag}"] = float(same)
        del q, k, v, do, o, lse, D
        torch.cuda.empty_cache()
    return out


def run_turns(script: str, doc: str) -> int:
    """The A/B harness of a timing script whose ``--time ROOT`` prints one
    turn's JSON: parse ``A_ROOT [B_ROOT]`` from the command line, run the
    turns A, B, B, A in fresh processes, print each turn and, per numeric
    key that every turn has, the median of each root's turns and their
    ratio, beside the card's name and power limit."""
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(doc, file=sys.stderr)
        return 2
    roots = {"A": Path(sys.argv[1]).resolve(),
             "B": Path(sys.argv[2] if len(sys.argv) > 2
                       else Path(__file__).resolve().parents[1]).resolve()}
    turns = []
    for name in ("A", "B", "B", "A"):
        r = subprocess.run([sys.executable, script, "--time",
                            str(roots[name])], capture_output=True,
                           text=True, timeout=900)
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
    # the numbers every turn has (a turn may add others, as a dict)
    for key in turns[0][1]:
        if not all(isinstance(t.get(key), (int, float)) for _, t in turns):
            continue
        med = {n: statistics.median(t[key] for m, t in turns if m == n)
               for n in ("A", "B")}
        summary[key] = {"A": med["A"], "B": med["B"],
                        "B_over_A": med["B"] / med["A"] if med["A"] else None}
    print(smi)
    print(json.dumps(summary))
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--time"]:
        print(json.dumps(time_root(Path(sys.argv[2]).resolve())))
        return 0
    return run_turns(__file__, __doc__)


if __name__ == "__main__":
    sys.exit(main())

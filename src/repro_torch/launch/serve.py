"""Serving launcher (smoke-scale), the port of ``repro.launch.serve``:
batched requests through the continuous-batching engine with
coflow-ordered admission.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --requests 8 --device cpu

``--device`` defaults to ``cuda`` (a card; there the prefill attention runs
the flash_attention kernel, and the admission's scheduling session plans
through the card's kernels).  ``--arch`` takes every decoder-only config
at its smoke size (``--arch mamba2-2.7b``, ``--arch granite-moe-3b`` and
the other MoE configs); an encoder-decoder or VLM config serves
qwen3-1.7b's smoke config instead, as the reference's launcher does.
``--admission`` takes ``coflow`` (the default: order by the live
``SchedulerSession``'s frontier) and ``fifo``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..configs import get_config
from ..kernels import resolve_device
from ..models import init_lm
from ..serve import Request, ServeConfig, ServingEngine


def main(argv: "list[str] | None" = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--admission", choices=("coflow", "fifo"),
                    default="coflow")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).smoke()
    if cfg.family != "lm":
        cfg = get_config("qwen3-1.7b").smoke()
    params = init_lm(cfg, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    reqs = [
        Request(rid=i,
                tokens=rng.integers(1, cfg.vocab, size=rng.integers(4, 17)),
                max_new=args.max_new,
                weight=float(rng.uniform(0.5, 2.0)),
                arrival=float(i // 2))
        for i in range(args.requests)
    ]
    eng = ServingEngine(cfg, params, ServeConfig(
        slots=args.slots, capacity=64, admission=args.admission))
    stats = eng.run(reqs)
    print(json.dumps({**stats, "admission": args.admission,
                      "device": str(dev)}))


if __name__ == "__main__":
    main()

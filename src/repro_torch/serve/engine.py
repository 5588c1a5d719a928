"""Batched serving engine, the port of ``repro.serve.engine``.

Continuous batching over a fixed slot budget: prefill admits requests into
free slots, decode advances every active slot one token per step, each
token the greedy argmax, as the reference's ``ServingEngine.run``.  The
model runs where its parameters lie: on a card, every prefill's attention
goes through the flash_attention kernel.  After prefill, each attention
layer's k and v are padded to the slot's capacity; a mamba layer's state
(h, conv) has no sequence axis and is kept as it is.

Admission order: this slice serves ``admission="fifo"`` (by arrival, then
rid).  The reference's ``"coflow"`` admission and its ``backpressure``
policy read the order from a live ``SchedulerSession``, which the port has
not yet (ROADMAP Queue 1 item 6); an engine asked for either raises
``NotImplementedError`` at construction.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.common import ArchConfig
from ..models.lm import decode_step, prefill

__all__ = ["Request", "ServeConfig", "ServingEngine"]

_SESSION_ITEM = ("the scheduling session is not ported yet (ROADMAP Queue 1 "
                 "item 6)")


@dataclass
class Request:
    rid: int
    tokens: np.ndarray          # prompt token ids
    max_new: int
    weight: float = 1.0
    arrival: float = 0.0
    out: list[int] = field(default_factory=list)
    done: bool = False
    finish_step: int = -1


@dataclass
class ServeConfig:
    slots: int = 4              # concurrent decode slots (continuous batch)
    capacity: int = 256         # KV capacity per slot
    admission: str = "coflow"   # "coflow" (Algorithm 5) | "fifo"
    ports: int = 8              # abstract port model of the interconnect
    backpressure: object | None = None   # an AdmissionPolicy (session)

    def __post_init__(self):
        # validated as the reference validates, at construction
        for name in ("slots", "capacity", "ports"):
            v = getattr(self, name)
            if isinstance(v, bool) or not isinstance(v, int) or v < 1:
                raise ValueError(f"{name} must be a positive int, got {v!r}")
        if self.ports < 2:
            raise ValueError(f"ports must be >= 2 (a coflow needs distinct "
                             f"src/dst ports), got {self.ports}")
        if self.admission not in ("coflow", "fifo"):
            raise ValueError(f"unknown admission {self.admission!r}; "
                             f"choose from ('coflow', 'fifo')")


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params: dict, serve: ServeConfig):
        if serve.admission == "coflow":
            raise NotImplementedError(
                f"admission='coflow' needs the scheduling session: "
                f"{_SESSION_ITEM}; use admission='fifo'")
        if serve.backpressure is not None:
            raise NotImplementedError(
                f"backpressure needs the scheduling session: {_SESSION_ITEM}")
        self.cfg = cfg
        self.params = params
        self.sc = serve
        self.device = params["embed"].device

    def _admission_order(self, pending: list[Request],
                         step: int = 0) -> list[Request]:
        return sorted(pending, key=lambda r: (r.arrival, r.rid))

    @torch.inference_mode()
    def run(self, requests: list[Request], max_steps: int = 10_000) -> dict:
        pending = list(requests)
        active: list[tuple[Request, dict]] = []
        step = 0
        while (pending or active) and step < max_steps:
            # admit ARRIVED requests into free slots
            pending = self._admission_order(pending, step)
            while pending and len(active) < self.sc.slots \
                    and pending[0].arrival <= step:
                r = pending.pop(0)
                toks = torch.as_tensor(np.asarray(r.tokens), dtype=torch.long,
                                       device=self.device)[None, :]
                logits, cache = prefill(self.cfg, self.params, toks)
                cache = self._pad_cache(cache, toks.shape[1])
                r.out.append(int(torch.argmax(logits[0])))
                active.append((r, cache))
            # one decode step per active slot (batch=1 per slot: slots may
            # hold different cache lengths)
            still = []
            for r, cache in active:
                tok = torch.tensor([[r.out[-1]]], dtype=torch.long,
                                   device=self.device)
                logits, cache = decode_step(self.cfg, self.params, cache, tok)
                r.out.append(int(torch.argmax(logits[0])))
                if len(r.out) >= r.max_new:
                    r.done = True
                    r.finish_step = step
                else:
                    still.append((r, cache))
            active = still
            step += 1
        return {
            "steps": step,
            "completed": sum(r.done for r in requests),
            "weighted_finish": sum(r.weight * r.finish_step
                                   for r in requests if r.done),
        }

    def _pad_cache(self, cache: dict, cur: int) -> dict:
        """Pad the attention leaves, named ``"k"`` and ``"v"`` ((nP, B, S,
        Hkv, dh)), to the capacity along S.  Leaves are chosen by name, not
        by shape: the reference pads every 5-d leaf whose axis 2 equals the
        prompt length, which also catches a mamba state h (nP, B, H, N, P)
        when the prompt has exactly H tokens."""
        cap = self.sc.capacity

        def pad(x):
            out = x.new_zeros((x.shape[0], x.shape[1], cap, *x.shape[3:]))
            out[:, :, :cur] = x
            return out

        return {"layers": {name: {key: pad(t) if key in ("k", "v") else t
                                  for key, t in leaves.items()}
                           for name, leaves in cache["layers"].items()},
                "length": cache["length"]}

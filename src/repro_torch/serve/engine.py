"""Batched serving engine, the port of ``repro.serve.engine``.

Continuous batching over a fixed slot budget: prefill admits requests into
free slots, decode advances every active slot one token per step, each
token the greedy argmax, as the reference's ``ServingEngine.run``.  The
model runs where its parameters lie: on a card, every prefill's attention
goes through the flash_attention kernel.  After prefill, each attention
layer's k and v are padded to the slot's capacity; a mamba layer's state
(h, conv) has no sequence axis and is kept as it is.

Admission ORDER is the paper's contribution applied to serving
(``admission="coflow"``, the default): outstanding requests are modeled as
path jobs (prefill coflow -> decode chain; weight = request priority,
release = arrival) on a live
:class:`~repro_torch.core.session.SchedulerSession` over an abstract port
model of the serving interconnect, one session per ``run()``, planning on
the engine's device (the device of the parameters).  Arrival ticks advance
the session clock, submit the new requests (suspending the active plan,
the paper's §VII-C.2 event protocol), and read admission order from
``session.frontier()`` — the planned-completion order under the live plan.
Ticks without arrivals neither replan nor touch the session: they reuse
the retained frontier at O(1).  With a ``backpressure`` policy
(:class:`~repro_torch.core.session.AdmissionPolicy`) due requests are held
while the session's windowed replan debt exceeds its budget.
``admission="fifo"`` orders by arrival, then rid.  ``admission_plan_s``
keeps the host seconds of each arrival tick's submit and replan.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.session import AdmissionPolicy, SchedulerSession
from ..core.types import Coflow, Job
from ..models.common import ArchConfig
from ..models.lm import decode_step, prefill

__all__ = ["Request", "ServeConfig", "ServingEngine"]


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
    backpressure: AdmissionPolicy | None = None   # hold admissions on debt

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
        if self.backpressure is not None and \
                not isinstance(self.backpressure, AdmissionPolicy):
            raise TypeError(f"backpressure must be an AdmissionPolicy or "
                            f"None, got {type(self.backpressure).__name__}")


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params: dict, serve: ServeConfig):
        self.cfg = cfg
        self.params = params
        self.sc = serve
        self.device = params["embed"].device
        # one scheduling session per run() (reset at entry, so an engine is
        # reusable across batches and rid numbering may restart): requests
        # are submitted once on arrival; admission queries the live frontier
        self._session = self._new_session()
        self._submitted: set[int] = set()
        self._frontier = None
        self.admission_plan_s: list[float] = []

    def _new_session(self) -> SchedulerSession:
        return SchedulerSession(self.sc.ports, "om_alg",
                                admission=self.sc.backpressure,
                                device=self.device)

    # --- admission ordering (the paper's machinery) ----------------------
    def _request_job(self, r: Request) -> Job:
        # prefill coflow: prompt bytes spread from the weight ports;
        # decode chain: one small coflow per new token (collapsed to one
        # aggregate coflow to keep ordering O(n))
        m = self.sc.ports
        d1 = np.zeros((m, m), dtype=np.int64)
        d1[r.rid % m, (r.rid + 1) % m] = max(len(r.tokens), 1)
        d2 = np.zeros((m, m), dtype=np.int64)
        d2[r.rid % m, (r.rid + 1) % m] = max(r.max_new, 1)
        return Job(r.rid, [Coflow(r.rid, 0, d1), Coflow(r.rid, 1, d2)],
                   [(0, 1)], weight=r.weight, release=int(r.arrival))

    def _admission_order(self, pending: list[Request],
                         step: int = 0) -> list[Request]:
        if self.sc.admission == "fifo" or len(pending) <= 1:
            return sorted(pending, key=lambda r: (r.arrival, r.rid))
        # only requests that have ARRIVED enter the session (so the session
        # never holds future releases and every submitted job shows a finite
        # planned completion); un-arrived requests sort last until their
        # tick, and duplicate rids share one session job (first wins)
        due = [r for r in pending
               if r.rid not in self._submitted and r.arrival <= step]
        if due and self._session.backpressure():
            # same signal the stream driver budgets on (core.stream): while
            # windowed replan debt exceeds the policy budget, hold the due
            # submissions — they stay pending (FIFO-ordered by the final
            # sort key below) and enter the session at a later tick
            self._session.stats.admission_deferred += len(due)
            due = []
        if due:
            t0 = time.perf_counter()
            for r in due:
                self._submitted.add(r.rid)
            # only arrival ticks touch the session: advance the fabric clock
            # to the tick, submit, and let frontier() replan once; planned
            # completions are static within an epoch, so no-arrival ticks
            # reuse the previous frontier at O(1)
            if step > self._session.now:
                self._session.advance(until=step)
            for r in due:
                self._session.submit(self._request_job(r))
            self._frontier = self._session.frontier()
            self.admission_plan_s.append(time.perf_counter() - t0)
        f = self._frontier
        if f is None:   # nothing has arrived yet
            return sorted(pending, key=lambda r: (r.arrival, r.rid))
        return sorted(pending,
                      key=lambda r: (f.completion(r.rid), r.arrival, r.rid))

    @torch.inference_mode()
    def run(self, requests: list[Request], max_steps: int = 10_000) -> dict:
        self._session = self._new_session()
        self._submitted = set()
        self._frontier = None
        self.admission_plan_s = []
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

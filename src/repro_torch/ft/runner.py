"""Fault-tolerant training runner, the port of ``repro.ft.runner``:

  * checkpoint every N steps with atomic writes and bounded retention
    (``ckpt/``);
  * auto-resume: on a (re)start the runner scans the checkpoint directory
    and continues from the newest valid step;
  * deterministic data: batches are a pure function of the step
    (``data/``), so a resume never replays or skips tokens;
  * failure injection (``fault_hook``: the tests crash the loop mid-run
    and assert a bit-exact continuation);
  * a straggler monitor: an EWMA of the step's wall time; steps slower
    than ``straggler_factor`` x the EWMA are flagged and counted.

It runs on `device` (default ``"cuda"``; pass ``"cpu"`` for the plain
versions).  The step's wall time is read after the device has finished
the step (``torch.cuda.synchronize``, as the reference's
``block_until_ready``).  On a card every op of a dense model's step is
deterministic (K4's backward sums in a fixed order, the embedding's
backward sorts), so a resumed run equals an uninterrupted one bit for bit.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import torch

from ..ckpt import CheckpointManager, latest_step, restore
from ..data.pipeline import DataConfig, SyntheticTokens
from ..kernels import resolve_device
from ..models.common import ArchConfig
from ..train.optim import OptConfig
from ..train.step import TrainState, build_train_step, init_train_state

__all__ = ["FTConfig", "TrainRunner", "StragglerMonitor"]


@dataclass
class FTConfig:
    ckpt_dir: str
    ckpt_every: int = 20
    keep: int = 3
    async_ckpt: bool = False
    straggler_factor: float = 3.0


class StragglerMonitor:
    def __init__(self, factor: float = 3.0, alpha: float = 0.2):
        self.factor = factor
        self.alpha = alpha
        self.ewma: float | None = None
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ewma is not None and dt > self.factor * self.ewma
        if slow:
            self.flagged.append((step, dt))
        else:  # stragglers do not poison the baseline
            self.ewma = dt if self.ewma is None else \
                (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


class TrainRunner:
    def __init__(self, cfg: ArchConfig, opt: OptConfig, data: DataConfig,
                 ft: FTConfig, seed: int = 0,
                 fault_hook: Callable[[int], None] | None = None,
                 bucket_order: list[list[str]] | None = None,
                 device: "torch.device | str" = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.opt = opt
        self.data = SyntheticTokens(cfg, data, device=self.device)
        self.ft = ft
        self.seed = seed
        self.fault_hook = fault_hook
        self.monitor = StragglerMonitor(ft.straggler_factor)
        self.ckpt = CheckpointManager(ft.ckpt_dir, every=ft.ckpt_every,
                                      keep=ft.keep, async_write=ft.async_ckpt)
        # bucket_order: the coflow planner's gradient-bucket launch order
        # (repro_torch.dist.planner.bucket_order_from_plan)
        self.bucket_order = bucket_order
        self.step_fn = build_train_step(cfg, opt, bucket_order=bucket_order)
        self.metrics_log: list[dict] = []

    def init_or_resume(self) -> tuple[TrainState, int]:
        step = latest_step(self.ft.ckpt_dir)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        state = init_train_state(self.cfg, gen, device=self.device)
        if step is None:
            return state, 0
        restored, manifest = restore(state, self.ft.ckpt_dir, step)
        return restored, int(manifest["step"])

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, n_steps: int) -> TrainState:
        state, start = self.init_or_resume()
        for step in range(start, n_steps):
            if self.fault_hook is not None:
                self.fault_hook(step)  # tests raise here to simulate a crash
            self._sync()
            t0 = time.perf_counter()
            batch = self.data.batch_at(step)
            state, metrics = self.step_fn(state, batch)
            self._sync()
            dt = time.perf_counter() - t0
            slow = self.monitor.observe(step, dt)
            self.metrics_log.append(
                {"step": step, "loss": float(metrics["loss"]),
                 "grad_norm": float(metrics["grad_norm"]),
                 "time_s": dt, "straggler": bool(slow)})
            self.ckpt.maybe_save(state, step + 1)
        self.ckpt.wait()
        return state

"""Composite scheduling results + metrics (TWCT, makespan, transcripts)."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .timeline import FinalSchedule
from .types import Instance

__all__ = ["CompositeSchedule", "twct", "Transcript", "TranscriptEntry"]


@dataclass
class TranscriptEntry:
    """Executed transmissions: coflow (jid, cid) moves units[k] on edge
    (srcs[k], dsts[k]) uniformly over wall-clock [t0, t1)."""

    jid: int
    cid: int
    t0: float
    t1: float
    srcs: np.ndarray
    dsts: np.ndarray
    units: np.ndarray


@dataclass
class Transcript:
    """Flat record of everything a schedule transmits; the online driver and
    the metrics layer consume only this."""

    entries: list[TranscriptEntry]

    def coflow_completions(self) -> dict[tuple[int, int], float]:
        remaining: dict[tuple[int, int], float] = {}
        total: dict[tuple[int, int], float] = {}
        last: dict[tuple[int, int], float] = {}
        for e in self.entries:
            key = (e.jid, e.cid)
            total[key] = total.get(key, 0.0) + float(e.units.sum())
            last.setdefault(key, e.t1)
        comp: dict[tuple[int, int], float] = {}
        # completion = earliest time cumulative units reach total
        per: dict[tuple[int, int], list[TranscriptEntry]] = {}
        for e in self.entries:
            per.setdefault((e.jid, e.cid), []).append(e)
        for key, es in per.items():
            tot = total[key]
            if tot <= 0:
                comp[key] = max(e.t1 for e in es)
                continue
            es_sorted = sorted(es, key=lambda e: e.t1)
            acc = 0.0
            for e in es_sorted:
                acc += float(e.units.sum())
                if acc >= tot - 1e-9:
                    comp[key] = e.t1
                    break
        return comp

    def job_completions(self) -> dict[int, float]:
        out: dict[int, float] = {}
        for (jid, _), t in self.coflow_completions().items():
            out[jid] = max(out.get(jid, 0.0), t)
        return out


@dataclass
class CompositeSchedule:
    """A sequence of FinalSchedules on a shared wall-clock (G-DM groups,
    or the baseline's one-sub-schedule result)."""

    parts: list[FinalSchedule]
    instance: Instance
    meta: dict = field(default_factory=dict)

    def job_completions(self) -> dict[int, float]:
        out: dict[int, float] = {}
        for p in self.parts:
            for jid, t in p.job_completions().items():
                out[jid] = max(out.get(jid, 0.0), t)
        return out

    def coflow_completions(self) -> dict[tuple[int, int], float]:
        out: dict[tuple[int, int], float] = {}
        for p in self.parts:
            for key, t in p.coflow_completions().items():
                out[key] = max(out.get(key, 0.0), t)
        return out

    @property
    def makespan(self) -> float:
        return max((p.makespan for p in self.parts), default=0.0)

    def twct(self, from_release: bool = False) -> float:
        return twct(self.job_completions(), self.instance, from_release)

    def transcript(self) -> Transcript:
        entries = [
            TranscriptEntry(e.jid, e.cid, float(e.e0), float(e.e1), e.srcs, e.dsts, e.units)
            for p in self.parts
            for e in p.ledger
        ]
        return Transcript(entries)


def twct(
    completions: dict[int, float], instance: Instance, from_release: bool = False
) -> float:
    """Total weighted completion time; from_release=True measures each job
    from its arrival (the paper's online metric)."""
    total = 0.0
    for j in instance.jobs:
        c = completions.get(j.jid)
        if c is None:
            raise KeyError(f"job {j.jid} has no completion")
        total += j.weight * (c - (j.release if from_release else 0.0))
    return total

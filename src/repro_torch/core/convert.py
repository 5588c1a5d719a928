"""Plain-data form of the port's state, so an instance or a transcript can
cross between this package and any other (the reference's tests build the
same instance in both and compare the transcripts) without either package
importing the other.

An instance is ``(m, jobs)``: each job a dict with ``jid``, ``weight``,
``release``, ``edges`` (list of (a, b) coflow pairs) and ``demands`` (list
of (m, m) int64 arrays, in coflow order).  A transcript is a list of
``(jid, cid, t0, t1, srcs, dsts, units)`` tuples in entry order.

``instance_to_arrays`` and ``transcript_to_arrays`` read only attributes
(``m``, ``jobs``, ``jid``, ``coflows``, ``demand``, ``entries``, ...), so
they take the reference's objects as well as the port's.
"""
from __future__ import annotations

import numpy as np

from .result import Transcript
from .types import Coflow, Instance, Job

__all__ = ["instance_from_arrays", "instance_to_arrays",
           "transcript_to_arrays"]


def instance_from_arrays(m: int, jobs: list[dict]) -> Instance:
    """The port's Instance from plain data (see the module docstring)."""
    out = []
    for j in jobs:
        jid = int(j["jid"])
        coflows = [Coflow(jid, cid, np.array(d, dtype=np.int64))
                   for cid, d in enumerate(j["demands"])]
        out.append(Job(jid, coflows,
                       [(int(a), int(b)) for a, b in j["edges"]],
                       weight=float(j["weight"]),
                       release=int(j["release"])))
    return Instance(int(m), out)


def instance_to_arrays(instance) -> tuple[int, list[dict]]:
    """Plain data of an instance (this package's or the reference's)."""
    return int(instance.m), [
        {"jid": int(j.jid), "weight": float(j.weight),
         "release": int(j.release),
         "edges": [(int(a), int(b)) for a, b in j.edges],
         "demands": [np.array(c.demand, dtype=np.int64) for c in j.coflows]}
        for j in instance.jobs]


def transcript_to_arrays(t: Transcript) -> list[tuple]:
    """Plain data of a transcript (this package's or the reference's)."""
    return [(int(e.jid), int(e.cid), float(e.t0), float(e.t1),
             np.asarray(e.srcs).copy(), np.asarray(e.dsts).copy(),
             np.asarray(e.units).copy())
            for e in t.entries]

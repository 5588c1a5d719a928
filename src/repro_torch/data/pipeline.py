"""Deterministic synthetic data pipeline, the port of
``repro.data.pipeline``.

Tokens are a pure function of (seed, step, row): each row draws from its
own counter-based generator, a numpy ``Philox`` seeded from
``SeedSequence([seed, step, row])``, so any worker can regenerate any
batch.  Resume after a failure and elastic re-sharding need no loader
state beyond the step counter, and each data-parallel shard asks for rows
[lo, hi) of the global batch.  The reference draws from JAX's threefry
instead, so the two packages' batches differ in their bits and keep the
same contract: a batch is a pure function of the step, a shard's rows are
the same rows of the global batch, labels are the tokens shifted with -1
last, and about half of the transitions follow the affine rule.

Batches are built on the host (numpy) and moved to the caller's device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.common import ArchConfig

__all__ = ["DataConfig", "SyntheticTokens", "make_batch_specs"]


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0


def _generator(seed: int, step: int, row: int, stream: int = 0):
    """The counter-based generator of one (seed, step, row) and stream: 0
    for the tokens, 7 for a VLM's patches, 9 for an encoder's frames (the
    reference's fold-in constants)."""
    return np.random.Generator(np.random.Philox(
        np.random.SeedSequence([seed, step, row, stream])))


class SyntheticTokens:
    """Deterministic LM token stream (documents of geometric length packed
    with an EOS separator, so the distribution is not trivially uniform)."""

    def __init__(self, cfg: ArchConfig, data: DataConfig,
                 device: "torch.device | str" = "cpu"):
        self.cfg = cfg
        self.data = data
        self.device = torch.device(device)

    def batch_at(self, step: int, lo: int = 0, hi: int | None = None) -> dict:
        """Rows [lo, hi) of step `step`'s global batch, int32 tokens and
        labels (and float32 patches or frames), on the pipeline's device."""
        d = self.data
        hi = d.global_batch if hi is None else hi
        rows = range(lo, hi)
        toks = np.stack([self._row(_generator(d.seed, step, r))
                         for r in rows]) if hi > lo else \
            np.zeros((0, d.seq_len), np.int32)
        batch = {"tokens": toks, "labels": self._labels(toks)}
        if self.cfg.family == "vlm":
            shape = (self.cfg.n_image_tokens, self.cfg.d_model)
            batch = {"patches": self._normal(step, rows, 7, shape),
                     **batch}
        elif self.cfg.family == "encdec":
            shape = (self.cfg.encoder_seq, self.cfg.d_model)
            batch = {"frames": self._normal(step, rows, 9, shape), **batch}
        return {key: torch.from_numpy(x).to(self.device)
                for key, x in batch.items()}

    def _normal(self, step: int, rows, stream: int, shape) -> np.ndarray:
        """N(0, 0.02^2) float32 embeddings, one draw per row."""
        out = np.empty((len(rows), *shape), np.float32)
        for i, r in enumerate(rows):
            g = _generator(self.data.seed, step, r, stream)
            out[i] = g.standard_normal(shape, dtype=np.float32) * 0.02
        return out

    def _row(self, g: np.random.Generator) -> np.ndarray:
        """Markov-structured stream: with prob. 1/2 the next token is a fixed
        affine function of the current one, else fresh, so the corpus has
        ~0.5 bit/token of learnable structure (loss visibly decreases in
        integration tests) while staying a pure function of (seed, step,
        row).  EOS (0) at ~1/64 emulates packed short documents.  As in the
        reference's scan, the chain starts from the first fresh token and
        runs before the EOS gates are applied."""
        S, v = self.data.seq_len, self.cfg.vocab
        fresh = g.integers(1, v, size=S, dtype=np.int64)
        copy_gate = g.random(S) < 0.5
        eos = g.random(S) < 1.0 / 64
        toks = np.empty(S, np.int64)
        prev = int(fresh[0])
        for i in range(S):
            prev = (prev * 31 + 7) % (v - 1) + 1 if copy_gate[i] \
                else int(fresh[i])
            toks[i] = prev
        return np.where(eos, 0, toks).astype(np.int32)

    @staticmethod
    def _labels(tokens: np.ndarray) -> np.ndarray:
        return np.concatenate(
            [tokens[:, 1:], np.full((tokens.shape[0], 1), -1, tokens.dtype)],
            axis=1)


def make_batch_specs(cfg: ArchConfig, seq_len: int,
                     global_batch: int) -> dict:
    """Stand-ins for a training batch: tensors on the ``meta`` device with
    the batch's shapes and types (the reference's ShapeDtypeStructs)."""
    def f(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    base = {"tokens": f((global_batch, seq_len), torch.int32),
            "labels": f((global_batch, seq_len), torch.int32)}
    if cfg.family == "vlm":
        text = seq_len - cfg.n_image_tokens
        base = {"patches": f((global_batch, cfg.n_image_tokens,
                              cfg.d_model), torch.float32),
                "tokens": f((global_batch, text), torch.int32),
                "labels": f((global_batch, text), torch.int32)}
    elif cfg.family == "encdec":
        base = {"frames": f((global_batch, cfg.encoder_seq, cfg.d_model),
                            torch.float32),
                "tokens": f((global_batch, seq_len), torch.int32),
                "labels": f((global_batch, seq_len), torch.int32)}
    return base

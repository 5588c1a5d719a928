"""Abstract stand-ins for every model input of every (arch x shape) cell,
the port of ``repro.launch.specs``: tensors on the ``meta`` device (shapes
and types, no memory, no random draws), the reference's
``ShapeDtypeStruct``s from ``eval_shape``.  The dry run
(``launch.dryrun``) distributes them over its mesh and traces a step on
them."""
from __future__ import annotations

import torch

from ..configs import SHAPES, ShapeSpec
from ..models.common import ArchConfig

__all__ = ["abstract_params", "abstract_state", "abstract_cache",
           "input_specs"]


def abstract_params(cfg: ArchConfig) -> dict:
    """The parameter tree as ``meta`` tensors: every leaf's shape and type,
    no memory and no random draws (the reference's ``eval_shape`` of
    ``init_params``)."""
    from ..train.step import init_params

    return init_params(cfg, None, device="meta")


def abstract_state(cfg: ArchConfig):
    """The TrainState (parameters, float32 moments, int32 steps) on
    ``meta``."""
    from ..train.step import init_train_state

    return init_train_state(cfg, None, device="meta")


def abstract_cache(cfg: ArchConfig, batch: int, capacity: int) -> dict:
    """The empty decode cache at `capacity` on ``meta``; its ``length`` is
    a Python int (0), as ``decode_step`` keeps it, where the reference's is
    an int32 scalar."""
    if cfg.family == "encdec":
        from ..models import init_encdec_cache

        return init_encdec_cache(cfg, batch, capacity, device="meta")
    from ..models import init_decode_cache

    return init_decode_cache(cfg, batch, capacity, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeSpec | str) -> dict:
    """The step inputs for one cell.

    train:   {"batch": {tokens/labels/patches/frames...}}
    prefill: {"tokens": ..., (+ "frames"/"patches")}
    decode:  {"cache": <abstract cache at seq_len capacity>, "token": (B, 1)}
    """
    from ..data.pipeline import make_batch_specs

    if isinstance(shape, str):
        shape = SHAPES[shape]
    S, B = shape.seq_len, shape.global_batch

    def f(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind == "train":
        return {"batch": make_batch_specs(cfg, S, B)}
    if shape.kind == "prefill":
        if cfg.family == "encdec":
            return {"frames": f((B, cfg.encoder_seq, cfg.d_model),
                                torch.float32),
                    "tokens": f((B, S), torch.int32)}
        if cfg.family == "vlm":
            return {"patches": f((B, cfg.n_image_tokens, cfg.d_model),
                                 torch.float32),
                    "tokens": f((B, S - cfg.n_image_tokens), torch.int32)}
        return {"tokens": f((B, S), torch.int32)}
    # decode: one new token against a seq_len-capacity cache
    return {"cache": abstract_cache(cfg, B, S),
            "token": f((B, 1), torch.int32)}

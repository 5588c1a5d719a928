"""Abstract stand-ins for a model's state: the port of
``repro.launch.specs.abstract_params``.  The reference's other stand-ins
(``abstract_state``, ``abstract_cache``, ``input_specs``) serve its
512-device dry-run, which the port does not have yet."""
from __future__ import annotations

from ..models.common import ArchConfig

__all__ = ["abstract_params"]


def abstract_params(cfg: ArchConfig) -> dict:
    """The parameter tree as ``meta`` tensors: every leaf's shape and type,
    no memory and no random draws (the reference's ``eval_shape`` of
    ``init_params``)."""
    from ..train.step import init_params

    return init_params(cfg, None, device="meta")

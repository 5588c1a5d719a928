"""The port's model stack (decoder-only LMs of attention and mamba layers):
the reference's ``repro.models`` in PyTorch, attention through the
flash_attention kernel and ``lm_forward``'s mamba layers through the
ssd_scan kernel on a card."""

from .common import ArchConfig, LayerSpec, MoESpec, SSMSpec  # noqa: F401
from .convert import lm_params_from_numpy, lm_params_to_numpy  # noqa: F401
from .lm import (decode_step, init_decode_cache, init_lm,  # noqa: F401
                 lm_forward, prefill)

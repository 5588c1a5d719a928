"""The port's model stack: the reference's ``repro.models`` in PyTorch.
Decoder-only LMs of attention and mamba layers with dense or MoE MLPs,
the encoder-decoder (Whisper) and the VLM (LLaVA) backbones; attention
through the flash_attention kernel and ``lm_forward``'s mamba layers
through the ssd_scan kernel on a card."""

from .common import ArchConfig, LayerSpec, MoESpec, SSMSpec  # noqa: F401
from .convert import (encdec_params_from_numpy,  # noqa: F401
                      lm_params_from_numpy, lm_params_to_numpy)
from .lm import (decode_step, init_decode_cache, init_lm,  # noqa: F401
                 lm_forward, lm_loss, prefill)
from .encdec import (encdec_decode_step, encdec_forward,  # noqa: F401
                     encdec_loss, encdec_prefill, init_encdec,
                     init_encdec_cache)
from .vlm import init_vlm, vlm_loss, vlm_prefill  # noqa: F401

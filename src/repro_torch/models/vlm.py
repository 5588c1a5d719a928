"""VLM (LLaVA-NeXT) backbone, the port of ``repro.models.vlm``.  The
vision tower and anyres tiling are a stub, as in the reference: the model
takes precomputed patch embeddings (B, n_image_tokens, d_model), already
projected into the LM's embedding space; they occupy the first positions
of the sequence and the text tokens the rest.  The loss masks the image
positions.  Everything runs through ``lm``: on a card every prefill and
loss attention goes through the flash_attention kernel (K4)."""
from __future__ import annotations

import torch

from .common import ArchConfig
from .lm import embed_tokens, init_lm, lm_loss, prefill
from .sharding import shard

__all__ = ["init_vlm", "vlm_loss", "vlm_prefill"]


def init_vlm(cfg: ArchConfig, gen: "torch.Generator | None",
             device: "torch.device | str | None" = None) -> dict:
    return init_lm(cfg, gen, device=device)


def _embeds(cfg: ArchConfig, params: dict, patches: torch.Tensor,
            tokens: torch.Tensor) -> torch.Tensor:
    text = embed_tokens(cfg, params, tokens)
    return shard(torch.cat([patches.to(text.dtype), text], dim=1),
                 ("dp", None, None))


def vlm_loss(cfg: ArchConfig, params: dict, patches: torch.Tensor,
             tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """patches: (B, n_img, d); tokens, labels: (B, S_text).  The sequence
    is n_img + S_text long; the image positions carry label -1."""
    B, n_img = patches.shape[:2]
    x = _embeds(cfg, params, patches, tokens)
    full_labels = torch.cat([labels.new_full((B, n_img), -1), labels], dim=1)
    return lm_loss(cfg, params, None, full_labels, inputs_embeds=x)


def vlm_prefill(cfg: ArchConfig, params: dict, patches: torch.Tensor,
                tokens: torch.Tensor):
    """-> (last-position logits (B, V), cache of length n_img + S_text)."""
    x = _embeds(cfg, params, patches, tokens)
    dummy = torch.zeros(x.shape[:2], dtype=torch.long, device=x.device)
    return prefill(cfg, params, dummy, inputs_embeds=x)

"""llava-next-mistral-7b [vlm]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000 — anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Vision tower + anyres tiling is a STUB: input_specs() supplies precomputed
patch embeddings (anyres 4+1 tiles x 576 = 2880 image tokens) occupying the
first positions of the sequence. Mistral's 4096 sliding window is widened
to full causal attention (adaptation noted in DESIGN.md)."""
from ..models.common import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=32000,
    period=(LayerSpec("attn", "dense"),),
    n_periods=32,
    n_image_tokens=2880,
    rope_theta=1e6,
    remat="full",
)

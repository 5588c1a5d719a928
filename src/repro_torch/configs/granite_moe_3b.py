"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
(expert) vocab=49155, MoE 40e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]."""
from ..models.common import ArchConfig, LayerSpec, MoESpec

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="lm",
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,
    vocab=49155,
    period=(LayerSpec("attn", "moe"),),
    n_periods=32,
    moe=MoESpec(n_experts=40, top_k=8, d_ff_expert=512),
    rope_theta=1e4,
    remat="full",
)

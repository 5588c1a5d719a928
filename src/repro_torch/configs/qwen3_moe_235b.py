"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
(expert) vocab=151936, MoE 128e top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""
from ..models.common import ArchConfig, LayerSpec, MoESpec

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="lm",
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_head=128,
    d_ff=1536,
    vocab=151936,
    period=(LayerSpec("attn", "moe"),),
    n_periods=94,
    moe=MoESpec(n_experts=128, top_k=8, d_ff_expert=1536),
    qk_norm=True,
    rope_theta=1e6,
    remat="full",
)

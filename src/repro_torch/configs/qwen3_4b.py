"""qwen3-4b [dense]: 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936 — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]."""
from ..models.common import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="lm",
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=9728,
    vocab=151936,
    period=(LayerSpec("attn", "dense"),),
    n_periods=36,
    qk_norm=True,
    rope_theta=1e6,
    remat="full",
)

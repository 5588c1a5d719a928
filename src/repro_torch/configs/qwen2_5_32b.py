"""qwen2.5-32b [dense]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064 — GQA + QKV bias [hf:Qwen/Qwen2.5-0.5B; hf]."""
from ..models.common import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="lm",
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=27648,
    vocab=152064,
    period=(LayerSpec("attn", "dense"),),
    n_periods=64,
    qkv_bias=True,
    qk_norm=False,
    rope_theta=1e6,
    remat="full",
)

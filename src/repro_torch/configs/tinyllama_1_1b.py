"""tinyllama-1.1b [dense]: 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000 — llama2-arch small [arXiv:2401.02385; hf]."""
from ..models.common import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="tinyllama-1.1b",
    family="lm",
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=64,
    d_ff=5632,
    vocab=32000,
    period=(LayerSpec("attn", "dense"),),
    n_periods=22,
    rope_theta=1e4,
    remat="full",
)

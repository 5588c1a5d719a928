"""mamba2-2.7b [ssm]: 64L d_model=2560 (attention-free) vocab=50280,
ssm_state=128 — SSD state-space duality [arXiv:2405.21060].

Mamba2 defaults: expand=2 (d_inner=5120), headdim=64 (80 SSD heads),
1 state group, conv width 4."""
from ..models.common import ArchConfig, LayerSpec, SSMSpec

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="lm",
    d_model=2560,
    n_heads=1,          # unused (attention-free)
    n_kv_heads=1,
    d_head=64,
    d_ff=0,             # no MLP: the mamba block is the whole layer
    vocab=50280,
    period=(LayerSpec("mamba", "none"),),
    n_periods=64,
    ssm=SSMSpec(d_state=128, d_head=64, expand=2, n_groups=1, d_conv=4),
    remat="full",
)

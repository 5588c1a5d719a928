"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16e top-2 — Mamba+attention 1:7 interleave
[arXiv:2403.19887; hf].

Layer pattern: period of 8 = 7 mamba + 1 attention (position 4, Jamba's
placement), MoE on every other layer (odd positions), dense MLP elsewhere.
Jamba's Mamba-1 layers are realized with our Mamba2/SSD block (the SSD
duality form — TPU-native adaptation recorded in DESIGN.md)."""
from ..models.common import ArchConfig, LayerSpec, MoESpec, SSMSpec

_period = tuple(
    LayerSpec("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="lm",
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab=65536,
    period=_period,
    n_periods=9,
    moe=MoESpec(n_experts=16, top_k=2, d_ff_expert=24576),
    ssm=SSMSpec(d_state=128, d_head=64, expand=2, n_groups=8, d_conv=4),
    rope_theta=1e6,
    remat="full",
)

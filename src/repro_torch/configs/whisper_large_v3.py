"""whisper-large-v3 [audio]: enc-dec, 32L d_model=1280 20H (MHA kv=20)
d_ff=5120 vocab=51866 — conv frontend STUB [arXiv:2212.04356].

The assignment's shapes apply to the DECODER stream; the encoder runs the
standard 1500 mel-frame window as precomputed embeddings from input_specs()
(frontend stub). Positions are sinusoidal (adaptation noted in DESIGN.md)."""
from ..models.common import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_head=64,
    d_ff=5120,
    vocab=51866,
    period=(LayerSpec("attn", "dense"),),
    n_periods=32,          # decoder layers
    n_encoder_layers=32,
    encoder_seq=1500,
    rope_theta=1e4,
    remat="full",
)

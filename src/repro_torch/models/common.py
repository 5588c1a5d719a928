"""Shared model configuration, the port's copy of ``repro.models.common``.

One `ArchConfig` describes every assigned architecture through a *layer
pattern*: a period of LayerSpecs repeated n_periods times.  Parameters of
the stack are stacked per period (a leading n_periods axis on every leaf),
as in the reference; the port runs the periods as a Python loop.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

__all__ = ["LayerSpec", "MoESpec", "SSMSpec", "ArchConfig", "DTYPES"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_norm_topk: bool = True  # qwen3/granite renormalize top-k probs
    impl: str = "scatter"  # "scatter" | "shard_map" (the reference's routing)


@dataclass(frozen=True)
class SSMSpec:
    d_state: int = 128
    d_head: int = 64        # P
    expand: int = 2         # d_inner = expand * d_model
    n_groups: int = 1
    d_conv: int = 4
    chunk: int = 128


@dataclass(frozen=True)
class LayerSpec:
    kind: str = "attn"       # "attn" | "mamba"
    mlp: str = "dense"       # "dense" | "moe" | "none"


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str              # "lm" | "encdec" | "vlm"
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    period: tuple[LayerSpec, ...]
    n_periods: int
    d_head: int = 128
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    moe: MoESpec | None = None
    ssm: SSMSpec | None = None
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # encoder (enc-dec family only)
    n_encoder_layers: int = 0
    encoder_seq: int = 1500          # whisper: 30 s of mel frames -> 1500
    # vlm family only
    n_image_tokens: int = 0          # anyres patch-embedding prefix (stub)
    # execution policy (fields of the reference; the port dispatches
    # attention by device, so attn_impl chooses no path here)
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    attn_impl: str = "auto"          # "auto" | "ref" | "chunked" | "pallas"
    attn_chunk: int = 1024
    remat: str = "none"              # "none" | "full" | "dots"
    loss_chunk: int = 2048           # 0 = unchunked (loop-free) loss
    scan_unroll: bool = False        # unroll layer scans (cost probes only)
    decode_cache_layout: str = "heads"  # "heads" | "dh" (see decode_attention)
    seq_parallel: bool = False       # Megatron-SP residual sharding on seq
    max_seq: int = 32768             # decode cache capacity default

    @property
    def n_layers(self) -> int:
        return len(self.period) * self.n_periods

    @property
    def sub_quadratic(self) -> bool:
        """True if the stack has no dense full-attention bottleneck at 500k
        (SSM or hybrid): the long_500k cell runs only for these."""
        kinds = {s.kind for s in self.period}
        return "mamba" in kinds

    def param_count(self) -> int:
        """Parameter count, from the port's own parameter shapes (built on
        the ``meta`` device: no memory, no random draws)."""
        from . import lm as _lm

        params = _lm.init_lm(self, None, device="meta")
        return sum(x.numel() for x in _lm.tree_leaves(params))

    @property
    def padded_vocab(self) -> int:
        """Embedding/unembedding tables are padded to a multiple of 128
        (the reference's sharding-friendly padding; the padding columns
        are sliced off the logits)."""
        return (self.vocab + 127) // 128 * 128

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dict(
            d_model=64, n_heads=4, n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=128, vocab=256, n_periods=min(self.n_periods, 2), d_head=16,
            param_dtype="float32", compute_dtype="float32", max_seq=64,
            n_image_tokens=min(self.n_image_tokens, 8),
        )
        if self.moe:
            kw["moe"] = dataclasses.replace(self.moe, n_experts=4, top_k=2,
                                            d_ff_expert=32, capacity_factor=8.0)
        if self.ssm:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=16, d_head=8,
                                            n_groups=1, chunk=16)
        if self.family == "encdec":
            kw["n_encoder_layers"] = 2
            kw["encoder_seq"] = 16
        return self.replace(name=self.name + "-smoke", **kw)

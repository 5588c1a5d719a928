"""Architecture registry, the port's copy of ``repro.configs``: the 10
assigned architectures, each <id>.py exporting CONFIG (pure data, field
for field the reference's); get_config/list_configs resolve by id.

Shapes (assignment): every LM-family arch pairs with
    train_4k     seq 4096,  global batch 256   (train_step)
    prefill_32k  seq 32768, global batch 32    (serve prefill)
    decode_32k   seq 32768 KV, global batch 128 (serve decode, 1 new token)
    long_500k    seq 524288 KV, global batch 1  (long-context decode)
long_500k runs only for sub-quadratic stacks (SSM/hybrid); pure
full-attention archs skip it (recorded, per the assignment brief).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

from ..models.common import ArchConfig

ARCH_IDS = [
    "qwen2_5_32b",
    "qwen3_1_7b",
    "qwen3_4b",
    "tinyllama_1_1b",
    "jamba_1_5_large",
    "mamba2_2_7b",
    "qwen3_moe_235b",
    "granite_moe_3b",
    "whisper_large_v3",
    "llava_next_mistral_7b",
]

# assignment ids use dashes/dots; map both spellings
ALIASES = {
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen3-1.7b": "qwen3_1_7b",
    "qwen3-4b": "qwen3_4b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "mamba2-2.7b": "mamba2_2_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "whisper-large-v3": "whisper_large_v3",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_config(arch_id: str) -> ArchConfig:
    arch_id = ALIASES.get(arch_id, arch_id).replace("-", "_").replace(".", "_")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"{__name__}.{arch_id}")
    return mod.CONFIG


def list_configs() -> list[str]:
    return list(ARCH_IDS)


def shape_applicable(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) per the assignment's skip rules."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 500k dense decode excluded (quadratic-attention rule)"
    return True, ""


def cells(arch_id: str) -> list[tuple[str, bool, str]]:
    cfg = get_config(arch_id)
    return [(s, *shape_applicable(cfg, s)) for s in SHAPES]

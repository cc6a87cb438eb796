"""Architecture registry: --arch <id> resolves here.

Port of ``repro.configs.registry``; the ten model configs beside it are the
reference's, copied with only their import changed.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_ARCHS = [
    "rwkv6_3b", "qwen1_5_32b", "qwen2_7b", "deepseek_7b", "granite_3_2b",
    "kimi_k2_1t_a32b", "llama4_scout_17b_a16e", "jamba_v0_1_52b",
    "internvl2_76b", "seamless_m4t_medium",
]

ARCH_IDS = {
    "rwkv6-3b": "rwkv6_3b",
    "qwen1.5-32b": "qwen1_5_32b",
    "qwen2-7b": "qwen2_7b",
    "deepseek-7b": "deepseek_7b",
    "granite-3-2b": "granite_3_2b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "internvl2-76b": "internvl2_76b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}


def get_config(arch: str) -> ModelConfig:
    mod = ARCH_IDS.get(arch, arch.replace("-", "_").replace(".", "_"))
    m = importlib.import_module(f"repro_torch.configs.{mod}")
    return m.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    mod = ARCH_IDS.get(arch, arch.replace("-", "_").replace(".", "_"))
    m = importlib.import_module(f"repro_torch.configs.{mod}")
    return m.SMOKE_CONFIG


def all_archs() -> List[str]:
    return list(ARCH_IDS.keys())


def supported_shapes(cfg: ModelConfig) -> List[str]:
    """Shape cells this arch runs (long_500k needs sub-quadratic attention)."""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.rwkv or cfg.attn_period > 0:
        shapes.append("long_500k")
    return shapes

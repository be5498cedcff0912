"""Architecture config registry: one module per assigned architecture.

The same registry and the same values as the reference's
``repro/configs``; each module is data only (``CONFIG`` at published
width, ``SMOKE`` at a few narrow layers)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "qwen3_moe_235b_a22b",
    "mixtral_8x22b",
    "rwkv6_7b",
    "musicgen_medium",
    "qwen3_4b",
    "qwen1_5_4b",
    "gemma3_4b",
    "granite_34b",
    "jamba_v0_1_52b",
    "internvl2_76b",
]

ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def _module(arch: str):
    arch = ALIASES.get(arch, arch)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}

"""Architecture registry: ``get_config(arch_id)`` / ``get_config(arch_id, reduced=True)``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPE_ORDER, SHAPES, ModelConfig, ShapeSpec, shape_applicable

_MODULES = {
    "mamba2-2.7b": "mamba2_2_7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "qwen3-14b": "qwen3_14b",
    "qwen1.5-4b": "qwen1_5_4b",
    "deepseek-67b": "deepseek_67b",
    "olmo-1b": "olmo_1b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "whisper-small": "whisper_small",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}

ARCH_IDS = list(_MODULES)


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.REDUCED if reduced else mod.CONFIG


def get_shape(shape_id: str) -> ShapeSpec:
    return SHAPES[shape_id]


__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "SHAPE_ORDER",
    "ModelConfig",
    "ShapeSpec",
    "get_config",
    "get_shape",
    "shape_applicable",
]

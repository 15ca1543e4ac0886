"""Architecture registry: ``get_config("<arch-id>")`` for every assigned arch."""
from __future__ import annotations

import importlib

from .base import SHAPES, LayerSpec, ModelConfig, ShapeConfig, reduced

ARCH_IDS = [
    "whisper-tiny",
    "jamba-v0.1-52b",
    "tinyllama-1.1b",
    "qwen3-8b",
    "gemma2-27b",
    "h2o-danube-3-4b",
    "mamba2-780m",
    "granite-moe-1b-a400m",
    "olmoe-1b-7b",
    "qwen2-vl-72b",
]

_MODULES = {
    "whisper-tiny": "whisper_tiny",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "qwen3-8b": "qwen3_8b",
    "gemma2-27b": "gemma2_27b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "mamba2-780m": "mamba2_780m",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
}


def get_config(arch: str) -> ModelConfig:
    key = arch.replace("_", "-")
    if key not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f".{_MODULES[key]}", __package__)
    return mod.CONFIG


def cells(arch: str) -> list[str]:
    """Shape names applicable to this arch (long_500k only if sub-quadratic)."""
    cfg = get_config(arch)
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out


__all__ = ["ARCH_IDS", "SHAPES", "LayerSpec", "ModelConfig", "ShapeConfig",
           "cells", "get_config", "reduced"]

"""Configurations of the port: the Wan2.1-style I2V pipeline profiles and
the language models this port serves (``get_config('<arch-id>')``)."""
from __future__ import annotations

import importlib
from dataclasses import replace

from repro_torch.configs.base import (
    H100,
    LONG_CONTEXT_ARCHS,
    SHAPES,
    HardwareConfig,
    ModelConfig,
    ShapeConfig,
    supported_shapes,
)
from repro_torch.configs.wan_i2v import FULL, PORT, SMALL, WanPipelineConfig

_ARCH_MODULES = {
    "qwen3-1.7b": "repro_torch.configs.qwen3_1p7b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def _module(arch_id: str):
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port has: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_shape(shape_id: str) -> ShapeConfig:
    if shape_id not in SHAPES:
        raise KeyError(f"unknown shape {shape_id!r}; available: {sorted(SHAPES)}")
    return SHAPES[shape_id]


def port_config(arch_id: str) -> ModelConfig:
    """The model as one H100 serves it: every width, and the depth cut to
    the config module's ``PORT_LAYERS`` where it has one (deepseek-67b)."""
    mod = _module(arch_id)
    return replace(mod.CONFIG, num_layers=getattr(mod, "PORT_LAYERS",
                                                  mod.CONFIG.num_layers))


__all__ = ["ARCH_IDS", "FULL", "H100", "LONG_CONTEXT_ARCHS", "PORT", "SHAPES", "SMALL",
           "HardwareConfig", "ModelConfig", "ShapeConfig", "WanPipelineConfig",
           "get_config", "get_shape", "port_config", "supported_shapes"]

"""Configurations of the port: the Wan2.1-style I2V pipeline profiles and
the language models this port serves (``get_config('<arch-id>')``)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.wan_i2v import FULL, PORT, SMALL, WanPipelineConfig

_ARCH_MODULES = {
    "qwen3-1.7b": "repro_torch.configs.qwen3_1p7b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; the port has: "
                       f"{sorted(_ARCH_MODULES)} (ROADMAP Queue 1 lists the rest)")
    return importlib.import_module(_ARCH_MODULES[arch_id]).CONFIG


__all__ = ["ARCH_IDS", "FULL", "PORT", "SMALL", "ModelConfig", "ShapeConfig",
           "WanPipelineConfig", "get_config"]

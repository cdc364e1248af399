"""Configurations of the port: the Wan2.1-style I2V pipeline profiles."""
from repro_torch.configs.wan_i2v import FULL, PORT, SMALL, WanPipelineConfig

__all__ = ["FULL", "PORT", "SMALL", "WanPipelineConfig"]

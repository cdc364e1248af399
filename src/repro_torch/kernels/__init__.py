"""Hand-written CUDA kernels for Hopper (sm_90a) that replace the JAX
package's Pallas TPU kernels on the Wan I2V path.

Each kernel package has:
  csrc/*.cu — the CUDA C++ source, a plain C entry point bound with ctypes
  ops.py    — the wrapper: checks, allocation, launch, launch counter
  ref.py    — the plain PyTorch version (the CPU path, and the oracle)

``_build`` compiles all sources into one library at first use.
"""
from repro_torch.kernels.ddim_step import ddim_step
from repro_torch.kernels.flash_attention import flash_attention

__all__ = ["ddim_step", "flash_attention"]

"""Hand-written CUDA kernels for Hopper (sm_90a) that replace the JAX
package's Pallas TPU kernels on the port's paths: flash attention (the Wan
DiT and the LM's causal prefill) with a backward of the port's own (the
training path), the fused DDIM step, flash-decode over a float or an int8
KV cache, and the WKV6 recurrence of rwkv6's prefill with a backward of the
port's own (its training path).

Each kernel package has:
  csrc/*.cu — the CUDA C++ source, a plain C entry point bound with ctypes
  ops.py    — the wrapper: checks, allocation, launch, launch counter
  ref.py    — the plain PyTorch version (the CPU path, and the oracle)

``_build`` compiles all sources into one library at first use.
"""
from repro_torch.kernels.ddim_step import ddim_step
from repro_torch.kernels.decode_attention import (
    decode_attention_grouped,
    decode_attention_int8_grouped,
)
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_backward
from repro_torch.kernels.rwkv6_wkv import wkv6, wkv6_backward

__all__ = ["ddim_step", "decode_attention_grouped", "decode_attention_int8_grouped",
           "flash_attention", "flash_attention_backward", "wkv6", "wkv6_backward"]

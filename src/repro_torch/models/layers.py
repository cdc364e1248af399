"""Shared model layers of the Wan I2V path: RMS norm, RoPE frequencies,
head projections, full attention and the DDIM update.

The path is chosen by the tensor's device and nothing else: a CUDA tensor
goes through the hand-written kernels in ``repro_torch.kernels`` (which
launch or raise), a CPU tensor through their plain PyTorch versions.  There
is no switch that sends a CUDA tensor to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ddim_step, flash_attention


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Scales by ``1 + w``, in float32."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float,
               rotary_dim: int = 0):
    """positions [...] -> (sin, cos) of shape [..., rotary_dim // 2]."""
    rd = rotary_dim or head_dim
    exps = torch.arange(0, rd, 2, dtype=torch.float32,
                        device=positions.device) / rd
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=positions.device), exps)
    ang = positions.float()[..., None] * inv
    return torch.sin(ang), torch.cos(ang)


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B,S,D] @ w [D,H,hd] -> contiguous [B,S,H,hd]."""
    b, s, _ = x.shape
    return (x @ w.reshape(w.shape[0], -1)).view(b, s, w.shape[1], w.shape[2])


def merge_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B,S,H,hd] @ w [H,hd,D] -> [B,S,D]."""
    b, s = x.shape[:2]
    return x.reshape(b, s, -1) @ w.reshape(-1, w.shape[-1])


def attention_full(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention, q: [B,Sq,H,hd]; k, v: [B,Sk,KV,hd] ->
    [B,Sq,H,hd], through the flash kernel.  The Wan path needs no causal
    mask, window or explicit query positions."""
    return flash_attention(q, k, v, causal=False)


def ddim_update(x: torch.Tensor, eps: torch.Tensor, alpha_t,
                alpha_prev) -> torch.Tensor:
    """One deterministic (eta = 0) DDIM update, fused into ``c1*x + c2*eps``
    with host-side float32 coefficients (``repro_torch.kernels.ddim_step``)."""
    return ddim_step(x, eps, alpha_t, alpha_prev)

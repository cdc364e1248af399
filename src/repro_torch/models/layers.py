"""Shared model layers: RMS norm, RoPE, head projections, attention (causal
and non-causal flash prefill, flash-decode over a float or an int8 cache),
the per-token int8 quantizer, the SwiGLU MLP and the DDIM update.

The path is chosen by the tensor's device and nothing else: a CUDA tensor
goes through the hand-written kernels in ``repro_torch.kernels`` (which
launch or raise), a CPU tensor through their plain PyTorch versions.  There
is no switch that sends a CUDA tensor to the plain version.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import (
    ddim_step,
    decode_attention_grouped,
    decode_attention_int8_grouped,
    flash_attention,
)

#: Windowed (sliding-window) attention belongs to gemma3's local layers,
#: which the port does not carry yet.
_WINDOW_TODO = ("windowed attention is not ported: gemma3's local/global "
                "layers and their ring caches are the next slice (ROADMAP "
                "Queue 1, item 1)")


#: PyTorch's CUDA reduction sets how many lanes share one row's sum by the
#: number of rows, up to 16 (``setReduceConfig`` in ATen's Reduce.cuh), and
#: so a row's summation order: a decode step of one request at batch 1 would
#: norm its activations in another order than the same request in a slot
#: batch of 8, and its tokens could drift apart.  Means over the last axis
#: are therefore taken over at least this many rows (zero rows padded).
MIN_REDUCE_ROWS = 16


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis, keepdim, with a summation order that does
    not depend on how many rows ``x`` has (``MIN_REDUCE_ROWS``)."""
    rows = x.reshape(-1, x.shape[-1])
    n = rows.shape[0]
    if n < MIN_REDUCE_ROWS:
        rows = F.pad(rows, (0, 0, 0, MIN_REDUCE_ROWS - n))
    return rows.mean(dim=-1)[:n].reshape(*x.shape[:-1], 1)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Scales by ``1 + w``, in float32."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(row_mean(x * x) + eps)
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


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
               rotary_dim: int = 0) -> torch.Tensor:
    """x [B,S,H,hd]; sin/cos [B,S,rd/2] or [S,rd/2].  Rotates the first rd
    dims as interleaved pairs and passes the rest through."""
    rd = rotary_dim or x.shape[-1]
    if sin.dim() == 2:  # [S, rd/2] -> [1,S,1,rd/2]
        sin, cos = sin[None, :, None, :], cos[None, :, None, :]
    else:  # [B,S,rd/2] -> [B,S,1,rd/2]
        sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    rot = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([rot, xp], dim=-1) if rd < x.shape[-1] else rot


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B,S,D] @ w [D,H,hd] -> contiguous [B,S,H,hd]."""
    b, s, _ = x.shape
    return (x @ w.reshape(w.shape[0], -1)).view(b, s, w.shape[1], w.shape[2])


def merge_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B,S,H,hd] @ w [H,hd,D] -> [B,S,D]."""
    b, s = x.shape[:2]
    return x.reshape(b, s, -1) @ w.reshape(-1, w.shape[-1])


def attention_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k, v: [B,Sk,KV,hd] -> [B,Sq,H,hd], through the flash
    kernel.  Causal needs Sq == Sk."""
    if window:
        raise NotImplementedError(_WINDOW_TODO)
    return flash_attention(q, k, v, causal=causal)


def attention_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """The JAX package's memory-safe attention for long prompts (S > 2048).
    The flash kernel never forms the [S, S] scores, so the port runs it
    there too."""
    if window:
        raise NotImplementedError(_WINDOW_TODO)
    return flash_attention(q, k, v, causal=causal)


def _group(q: torch.Tensor, kv: int) -> torch.Tensor:
    b, h, d = q.shape
    return q.reshape(b, kv, h // kv, d)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_index, *,
                     window: int = 0) -> torch.Tensor:
    """One new token per row against the serving-layout cache.  q [B,H,hd];
    k/v cache [B,KV,Smax,hd]; cur_index an int (lockstep batch) or a [B]
    tensor (one position per slot).  -> [B,H,hd] through the flash-decode
    kernel, for both forms of the index."""
    if window:
        raise NotImplementedError(_WINDOW_TODO)
    out = decode_attention_grouped(_group(q, k_cache.shape[1]), k_cache,
                                   v_cache, cur_index)
    return out.reshape(q.shape)


def quantize_token_kv(x: torch.Tensor):
    """x [B,KV,T,hd] -> (int8 values, float32 scales [B,KV,T]): absmax per
    (head, token)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def attention_decode_int8(q: torch.Tensor, k_q: torch.Tensor, v_q: torch.Tensor,
                          k_s: torch.Tensor, v_s: torch.Tensor,
                          cur_index) -> torch.Tensor:
    """int8-cache decode: q [B,H,hd]; int8 k/v [B,KV,Smax,hd]; float32
    scales [B,KV,Smax]; the scales fold into the scores (k) and the
    probabilities (v) inside the kernel."""
    out = decode_attention_int8_grouped(_group(q, k_q.shape[1]), k_q, v_q,
                                        k_s, v_s, cur_index)
    return out.reshape(q.shape)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def ddim_update(x: torch.Tensor, eps: torch.Tensor, alpha_t,
                alpha_prev) -> torch.Tensor:
    """One deterministic (eta = 0) DDIM update, fused into ``c1*x + c2*eps``
    with host-side float32 coefficients (``repro_torch.kernels.ddim_step``)."""
    return ddim_step(x, eps, alpha_t, alpha_prev)

"""Plain PyTorch versions of the flash-decode kernels.

The same functions as the kernels in ``csrc/decode_attention.cu``: scores
and softmax in float32 with q scaled by D^-0.5 first, positions past
``cur_index`` masked, the output in q's type.  The int8 version multiplies
the scores by the k scales and the probabilities by the v scales before the
PV product, as the kernel does.  The CPU path of the wrappers runs them; on
the card they are what the kernels are held against.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _valid(cur_index: torch.Tensor, b: int, s: int, device) -> torch.Tensor:
    """[B, S] mask of the positions each row attends to."""
    cur = torch.as_tensor(cur_index, device=device).reshape(-1).expand(b)
    return torch.arange(s, device=device)[None, :] <= cur[:, None]


def _serving_layout(x: torch.Tensor, seq_axis: int) -> torch.Tensor:
    """A [B,S,KV,...] (seq_axis 1) or [B,KV,S,...] (seq_axis 2) cache ->
    a [B,KV,S,...] view."""
    return x.transpose(1, 2) if seq_axis == 1 else x


def decode_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               cur_index, *, seq_axis: int = 2) -> torch.Tensor:
    """q [B,KV,G,D]; k/v cache [B,KV,S,D] (seq_axis 2) or [B,S,KV,D]
    (seq_axis 1); cur_index an int, a 0-d or a [B] tensor -> [B,KV,G,D]."""
    k = _serving_layout(k_cache, seq_axis)
    v = _serving_layout(v_cache, seq_axis)
    b, _, _, d = q.shape
    qf = q.float() * d ** -0.5
    sc = torch.einsum("bngd,bntd->bngt", qf, k.float())
    valid = _valid(cur_index, b, k.shape[2], q.device)
    sc = sc.masked_fill(~valid[:, None, None, :], NEG_INF)
    pr = torch.softmax(sc, dim=-1)
    return torch.einsum("bngt,bntd->bngd", pr, v.float()).to(q.dtype)


def decode_int8_ref(q: torch.Tensor, k_q: torch.Tensor, v_q: torch.Tensor,
                    k_scale: torch.Tensor, v_scale: torch.Tensor, cur_index, *,
                    seq_axis: int = 2) -> torch.Tensor:
    """q [B,KV,G,D]; int8 k/v in either layout; float32 scales [B,KV,S]."""
    k = _serving_layout(k_q, seq_axis)
    v = _serving_layout(v_q, seq_axis)
    b, _, _, d = q.shape
    qf = q.float() * d ** -0.5
    sc = torch.einsum("bngd,bntd->bngt", qf, k.float()) * k_scale[:, :, None, :]
    valid = _valid(cur_index, b, k.shape[2], q.device)
    sc = sc.masked_fill(~valid[:, None, None, :], NEG_INF)
    pv = torch.softmax(sc, dim=-1) * v_scale[:, :, None, :]
    return torch.einsum("bngt,bntd->bngd", pv, v.float()).to(q.dtype)


def quantize_kv(cache: torch.Tensor):
    """[B,S,KV,D] float -> (int8 [B,S,KV,D], float32 scales [B,KV,S]):
    absmax per (position, head), as the JAX package's ``quantize_kv``."""
    absmax = cache.float().abs().amax(dim=-1)                    # [B,S,KV]
    scale = torch.clamp(absmax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(cache.float() / scale[..., None]),
                    -127, 127).to(torch.int8)
    return q, scale.transpose(1, 2).contiguous()

"""Plain PyTorch version of the WKV6 kernel: a loop over time.

Per batch row and head, with the float32 state S [K,V] (row k, column v):

    y_t = S^T r_t + (sum_k u k_t r_t) v_t
    S  <- w_t[:, None] S + k_t v_t^T

Every input is cast to float32 first (JAX promotes a bfloat16 operand
against the float32 state silently; ``torch.einsum`` refuses mixed types),
so this computes in float32 and returns y in r's type and the final state in
float32, as the Pallas kernel and the CUDA kernel do.
"""
from __future__ import annotations

from typing import Tuple

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, state: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: [B,T,H,K]; u: [H,K]; state: [B,H,K,K].
    Returns (y [B,T,H,K] in r.dtype, final state [B,H,K,K] float32)."""
    rf, kf, vf, wf, uf = (x.float() for x in (r, k, v, w, u))
    s = state.float()
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]
        y = torch.einsum("bhk,bhkv->bhv", rt, s)
        y = y + torch.einsum("bhk,bhk,bhv->bhv", uf[None] * kt, rt, vt)
        s = wt[..., None] * s + kt[..., None] * vt[:, :, None, :]
        ys.append(y)
    return torch.stack(ys, dim=1).to(r.dtype), s

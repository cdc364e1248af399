"""Plain PyTorch versions of the WKV6 kernels: loops over time.

Per batch row and head, with the state S [K,V] (row k, column v) and S_t
the state after step t (S_{-1} the initial state):

    y_t = S_{t-1}^T r_t + (sum_k u k_t r_t) v_t
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

``wkv6_ref`` is the forward, ``wkv6_bwd_ref`` its gradient by the reverse
recurrence.  Every input is cast to float32 first (JAX promotes a bfloat16
operand against the float32 state silently; ``torch.einsum`` refuses mixed
types), or to float64 where one is float64, so these compute in float32 and
return y and the gradients in their inputs' types and the states in float32,
as the Pallas kernel and the CUDA kernels do.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

#: Steps between the states that `wkv6_bwd_ref` keeps from its forward pass:
#: it recomputes the states inside a span from its first, so that a long
#: sequence does not hold all T states (34 GB at B 8, T 4096, H 64, K 64).
BWD_REF_SPAN = 64


def _work_type(*xs) -> torch.dtype:
    dt = torch.float32
    for x in xs:
        dt = torch.promote_types(dt, x.dtype)
    return dt


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, state: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: [B,T,H,K]; u: [H,K]; state: [B,H,K,K].
    Returns (y [B,T,H,K] in r.dtype, final state [B,H,K,K] float32)."""
    dt = _work_type(r, k, v, w, u, state)
    rf, kf, vf, wf, uf = (x.to(dt) for x in (r, k, v, w, u))
    s = state.to(dt)
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]
        y = torch.einsum("bhk,bhkv->bhv", rt, s)
        y = y + torch.einsum("bhk,bhk,bhv->bhv", uf[None] * kt, rt, vt)
        s = wt[..., None] * s + kt[..., None] * vt[:, :, None, :]
        ys.append(y)
    return torch.stack(ys, dim=1).to(r.dtype), s


def wkv6_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                 u: torch.Tensor, state: torch.Tensor, dy: torch.Tensor,
                 dstate_out: Optional[torch.Tensor] = None):
    """The gradient of ``wkv6_ref`` for the output gradient dy [B,T,H,K] and
    the final state's gradient ``dstate_out`` [B,H,K,K] (zero when None):
    -> (dr, dk, dv, dw, du, dstate), each in its input's type, dstate (the
    initial state's) in float32.  With dS_t the gradient of S_t, dS_{T-1} =
    dstate_out, and vdy_t = v_t . dy_t, step by step from the last:

        dr_t = S_{t-1} dy_t + (u k_t) vdy_t
        dk_t = dS_t v_t + (u r_t) vdy_t
        dv_t = dS_t^T k_t + (sum_k u k_t r_t) dy_t
        dw_t = sum_v dS_t . S_{t-1}
        du  += sum_b (k_t r_t) vdy_t
        dS_{t-1} = diag(w_t) dS_t + r_t dy_t^T

    S_{t-1} is recomputed forward, never recovered from S_t by dividing by
    w_t (which the model rounds to exact zeros): the forward pass keeps the
    state at the start of every span of `BWD_REF_SPAN` steps, and each span
    is recomputed from its start before it is walked back."""
    dt = _work_type(r, k, v, w, u, state, dy)
    rf, kf, vf, wf, uf, dyf = (x.to(dt) for x in (r, k, v, w, u, dy))
    b, t_len, h, kk = r.shape

    def advance(s, t):
        return wf[:, t, ..., None] * s + kf[:, t, ..., None] * vf[:, t, :, None, :]

    starts, s = [], state.to(dt)
    for t in range(t_len):
        if t % BWD_REF_SPAN == 0:
            starts.append(s)
        s = advance(s, t)
    ds = (torch.zeros_like(s) if dstate_out is None else dstate_out.to(dt))
    dr, dk, dv, dw = (torch.empty(b, t_len, h, kk, dtype=dt, device=r.device)
                      for _ in range(4))
    du = torch.zeros(h, kk, dtype=dt, device=r.device)
    for span in reversed(range(len(starts))):
        t0 = span * BWD_REF_SPAN
        t1 = min(t0 + BWD_REF_SPAN, t_len)
        prev = [starts[span]]                  # prev[i] = S_{t0 + i - 1}
        for t in range(t0, t1 - 1):
            prev.append(advance(prev[-1], t))
        for t in reversed(range(t0, t1)):
            sp = prev[t - t0]
            rt, kt, vt, wt, dyt = rf[:, t], kf[:, t], vf[:, t], wf[:, t], dyf[:, t]
            vdy = (vt * dyt).sum(-1, keepdim=True)                  # [B,H,1]
            dr[:, t] = torch.einsum("bhkv,bhv->bhk", sp, dyt) + uf * kt * vdy
            dk[:, t] = torch.einsum("bhkv,bhv->bhk", ds, vt) + uf * rt * vdy
            dv[:, t] = (torch.einsum("bhkv,bhk->bhv", ds, kt)
                        + (uf * kt * rt).sum(-1, keepdim=True) * dyt)
            dw[:, t] = (ds * sp).sum(-1)
            du = du + (kt * rt * vdy).sum(0)
            ds = wt[..., None] * ds + rt[..., None] * dyt[:, :, None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype), du.to(u.dtype),
            ds)

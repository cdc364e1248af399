"""Plain PyTorch versions of the flash-attention kernel and of its backward.

The same function as the kernel, computed one (batch, head) pair and one
chunk of query rows at a time, so that the [Sq, Sk] score matrix of a
full-size DiT call (18,900 x 18,900 per head) never exists for all heads at
once.  The CPU path of the wrapper runs it; on the card it is what the
kernel is held against.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, sm_scale=None, q_chunk: int = 4096,
                  return_lse: bool = False):
    """q: [B,Sq,H,D]; k, v: [B,Sk,KV,D] with H % KV == 0.  Query head h
    reads kv head h // (H // KV).  Causal masks key j > query i (Sq == Sk).
    Returns [B,Sq,H,D] in q's dtype; scores and softmax in float32.  With
    ``return_lse`` also each row's log-sum-exp of the scaled, masked scores
    (natural log), float32 [B,H,Sq]: what the bfloat16 forward kernel
    stores for its backward."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    group = h // kv
    scale = sm_scale if sm_scale is not None else d ** -0.5
    out = torch.empty_like(q)
    lse = torch.empty(b, h, sq, dtype=torch.float32, device=q.device) if return_lse else None
    kpos = torch.arange(sk, device=q.device)
    for bi in range(b):
        for hi in range(h):
            kh = k[bi, :, hi // group].float()
            vh = v[bi, :, hi // group].float()
            for r0 in range(0, sq, q_chunk):
                qh = q[bi, r0:r0 + q_chunk, hi].float() * scale
                s = qh @ kh.T
                if causal:
                    qpos = torch.arange(r0, r0 + qh.shape[0], device=q.device)
                    s = s.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
                p = torch.softmax(s, dim=-1)
                out[bi, r0:r0 + q_chunk, hi] = (p @ vh).to(q.dtype)
                if return_lse:
                    lse[bi, hi, r0:r0 + q_chunk] = torch.logsumexp(s, dim=-1)
    return (out, lse) if return_lse else out


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, *, causal: bool = False,
                      sm_scale=None, q_chunk: int = 4096, lse=None):
    """The gradient of ``attention_ref``: (dq, dk, dv) for the output
    gradient ``do`` [B,Sq,H,D], given the forward's output ``o``.  In
    float32, one (batch, head) pair and one chunk of query rows at a time:
    P from the recomputed scores (exp(s - lse) where the forward's
    log-sum-exp ``lse`` [B,H,Sq] is given, else their softmax), dP = dO V^T, delta = rowsum(dO o), dS =
    P (dP - delta), dq = dS K scale, dk = dS^T Q scale, dv = P^T dO.  dk and
    dv of a kv head sum over its group of query heads in float32 and round
    once; each result in its input's type."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    group = h // kv
    scale = sm_scale if sm_scale is not None else d ** -0.5
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    kpos = torch.arange(sk, device=q.device)
    for bi in range(b):
        for hi in range(h):
            kh = k[bi, :, hi // group].float()
            vh = v[bi, :, hi // group].float()
            for r0 in range(0, sq, q_chunk):
                qh = q[bi, r0:r0 + q_chunk, hi].float() * scale
                doh = do[bi, r0:r0 + q_chunk, hi].float()
                s = qh @ kh.T
                if causal:
                    qpos = torch.arange(r0, r0 + qh.shape[0], device=q.device)
                    s = s.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
                if lse is None:
                    p = torch.softmax(s, dim=-1)
                else:
                    p = torch.exp(s - lse[bi, hi, r0:r0 + q_chunk, None].float())
                delta = (doh * o[bi, r0:r0 + q_chunk, hi].float()).sum(-1, keepdim=True)
                ds = p * (doh @ vh.T - delta)
                dq[bi, r0:r0 + q_chunk, hi] = (ds @ kh * scale).to(q.dtype)
                dk[bi, :, hi // group] += ds.T @ qh
                dv[bi, :, hi // group] += p.T @ doh
    return dq, dk.to(k.dtype), dv.to(v.dtype)

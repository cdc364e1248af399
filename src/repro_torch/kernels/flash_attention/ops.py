"""Public flash-attention wrapper: [B,S,H,D] layout, native GQA, float32 or
bfloat16, differentiable.

A tensor on the CPU goes to the plain versions (``ref.attention_ref``
forward, ``ref.attention_bwd_ref`` backward); a tensor on the card launches
the CUDA kernels of its type or raises: the forward on the tensor cores
(float32 as three TF32 products: ``csrc/flash_attention.cu``; bfloat16:
``csrc/flash_attention_bf16.cu``), the backward in
``csrc/flash_attention_bwd.cu``.  ``flash_attention.launches`` counts the
forward kernel's launches and ``flash_attention_backward.launches`` the
backward's, and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

HEAD_DIMS = (32, 64, 128)
_ENTRY = {torch.float32: "repro_flash_attention_f32",
          torch.bfloat16: "repro_flash_attention_bf16"}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, causal: bool):
    """Shapes, and on the card what the kernels take."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if k.shape != (b, sk, kv, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} kv heads")
    if causal and sq != sk:
        raise ValueError(f"causal flash attention needs Sq == Sk, got {sq}/{sk}")
    if q.device.type == "cpu":
        return
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs all "
                             f"of q, k, v on one CUDA device")
        if t.dtype != q.dtype or t.dtype not in _ENTRY:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}; the kernel "
                            f"takes float32 or bfloat16, the same for all")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if b * h > 65535 or sq == 0 or sk == 0:
        raise ValueError(f"shape B*H={b * h}, Sq={sq}, Sk={sk} not supported")


def _forward(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, sm_scale=scale)
    (b, sq, h, d), (sk, kv) = q.shape, k.shape[1:3]
    o = torch.empty_like(q)
    err = getattr(_build.library(), _ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, h, kv, sq, sk, d, int(causal), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    _build.count_launch(flash_attention)
    return o


def _backward(q, k, v, o, do, causal: bool, scale: float):
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, do, causal=causal, sm_scale=scale)
    (b, sq, h, d), (sk, kv) = q.shape, k.shape[1:3]
    for name, t in (("o", o), ("do", do)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{q.dtype} tensor of q's shape {tuple(q.shape)}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lse = torch.empty(b * h * sq, dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    err = _build.library().repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        b, h, kv, sq, sk, d, int(causal), _DTYPE_CODE[q.dtype], scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_backward")
    _build.count_launch(flash_attention_backward)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient; on the
    CPU both plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o = _forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        return (*_backward(q, k, v, o, do.contiguous(), ctx.causal, ctx.scale),
                None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, sm_scale=None) -> torch.Tensor:
    """q: [B,Sq,H,D]; k, v: [B,Sk,KV,D] with H % KV == 0 (GQA without
    repeats).  Non-causal allows Sq != Sk; causal needs Sq == Sk.  Keys past
    Sk are masked inside the kernel, so nothing is padded.  A gradient
    flows to q, k and v through ``flash_attention_backward``."""
    _check(q, k, v, causal)
    scale = float(sm_scale) if sm_scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, causal, scale)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = False, sm_scale=None):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` = ``o`` for the output
    gradient ``do`` [B,Sq,H,D]; dk and dv sum over each kv head's group of
    query heads.  Deterministic on the card (no atomics)."""
    _check(q, k, v, causal)
    scale = float(sm_scale) if sm_scale is not None else q.shape[-1] ** -0.5
    return _backward(q, k, v, o, do, causal, scale)


flash_attention.launches = 0
flash_attention_backward.launches = 0

"""Public flash-attention wrapper: [B,S,H,D] layout, native GQA, float32 or
bfloat16.

A tensor on the CPU goes to the plain version (``ref.attention_ref``); a
tensor on the card launches the CUDA kernel of its type, both on the tensor
cores (float32 as three TF32 products: ``csrc/flash_attention.cu``;
bfloat16: ``csrc/flash_attention_bf16.cu``) or raises.  ``flash_attention.launches``
counts the kernel launches and nothing else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (32, 64, 128)
_ENTRY = {torch.float32: "repro_flash_attention_f32",
          torch.bfloat16: "repro_flash_attention_bf16"}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, sm_scale=None) -> torch.Tensor:
    """q: [B,Sq,H,D]; k, v: [B,Sk,KV,D] with H % KV == 0 (GQA without
    repeats).  Non-causal allows Sq != Sk; causal needs Sq == Sk.  Keys past
    Sk are masked inside the kernel, so nothing is padded."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if k.shape != (b, sk, kv, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} kv heads")
    if causal and sq != sk:
        raise ValueError(f"causal flash attention needs Sq == Sk, got {sq}/{sk}")
    scale = float(sm_scale) if sm_scale is not None else d ** -0.5
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, sm_scale=scale)

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

    o = torch.empty_like(q)
    lib = _build.library()
    err = getattr(lib, _ENTRY[q.dtype])(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, h, kv, sq, sk, d, int(causal), scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    _build.count_launch(flash_attention)
    return o


flash_attention.launches = 0

"""Public WKV6 wrapper: [B,T,H,K] inputs, any T >= 1, float32 or bfloat16.

A tensor on the CPU goes to the plain version (``ref.wkv6_ref``, which
autograd differentiates); a tensor on the card launches the CUDA kernel
(``csrc/wkv6.cu``) or raises, and raises too under grad mode when an input
needs a gradient, since the kernel has no backward yet.
``wkv6.launches`` counts the kernel launches and nothing else.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_ref

HEAD_SIZES = (32, 64)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: [B,T,H,K]; u: [H,K]; state: [B,H,K,K] float32 (row k,
    column v).  Returns (y [B,T,H,K] in r.dtype, final state float32)."""
    b, t, h, kk = r.shape
    for name, x in (("k", k), ("v", v), ("w", w)):
        if x.shape != r.shape:
            raise ValueError(f"r {tuple(r.shape)} and {name} {tuple(x.shape)} differ")
    if u.shape != (h, kk) or state.shape != (b, h, kk, kk):
        raise ValueError(f"u {tuple(u.shape)} / state {tuple(state.shape)} do not "
                         f"fit r {tuple(r.shape)}")
    if t == 0:
        raise ValueError("wkv6 needs at least one time step")
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, state)
    _build.refuse_grad("wkv6", r, k, v, w, u, state)

    for name, x in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u), ("state", state)):
        if x.device != r.device or x.device.type != "cuda":
            raise ValueError(f"{name} is on {x.device}; the kernel needs every "
                             f"input on one CUDA device")
        want = torch.float32 if name == "state" else r.dtype
        if x.dtype != want or r.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} is {x.dtype}; the kernel takes r, k, v, w, u "
                            f"all float32 or all bfloat16 and a float32 state")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if kk not in HEAD_SIZES:
        raise ValueError(f"head size {kk} not in {HEAD_SIZES}")

    y = torch.empty_like(r)
    s_out = torch.empty_like(state)
    err = _build.library().repro_wkv6(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        state.data_ptr(), y.data_ptr(), s_out.data_ptr(), b, t, h, kk,
        _DTYPE_CODE[r.dtype], torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "wkv6")
    _build.count_launch(wkv6)
    return y, s_out


wkv6.launches = 0

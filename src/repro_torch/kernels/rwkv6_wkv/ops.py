"""Public WKV6 wrapper: [B,T,H,K] inputs, any T >= 1, float32 or bfloat16,
differentiable.

A tensor on the CPU goes to the plain version (``ref.wkv6_ref``, which
autograd differentiates); a tensor on the card launches the CUDA kernels or
raises: the forward (``csrc/wkv6.cu``) and, where an input needs a gradient,
the backward (``csrc/wkv6_bwd.cu``) as its gradient.
``wkv6.launches`` counts the forward kernel's launches and
``wkv6_backward.launches`` the backward's (one per call), and nothing else.

The forward and the backward are custom ops (``torch.ops.repro.wkv6``,
``wkv6_backward``) under the autograd Function: a fake tensor (the
dry-run's) takes their fake implementation, and a flop formula counts their
work.  A real CPU tensor keeps the plain loop, which autograd differentiates,
and a real tensor with no dispatch mode active skips the ops' dispatch and
runs their bodies (``_build.entry``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_bwd_ref, wkv6_ref

HEAD_SIZES = (32, 64)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: Time steps per chunk of the backward kernel (``C`` in csrc/wkv6_bwd.cu):
#: its state pass keeps each chunk's start but the first.
BWD_CHUNK = 64


def _check(r, k, v, w, u, state):
    """Shapes, and on the card what the kernels take."""
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
        return
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


def _forward(r, k, v, w, u, state):
    b, t, h, kk = r.shape
    y = torch.empty_like(r)
    s_out = torch.empty_like(state)
    err = _build.library().repro_wkv6(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        state.data_ptr(), y.data_ptr(), s_out.data_ptr(), b, t, h, kk,
        _DTYPE_CODE[r.dtype], torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "wkv6")
    _build.count_launch(wkv6)
    return y, s_out


def _backward(r, k, v, w, u, state, dy, dstate_out):
    if r.device.type == "cpu":
        return wkv6_bwd_ref(r, k, v, w, u, state, dy, dstate_out)
    b, t, h, kk = r.shape
    if (dy.shape != r.shape or dy.dtype != r.dtype or dy.device != r.device
            or not dy.is_contiguous() or dy.data_ptr() % 16):
        raise ValueError(f"dy must be a contiguous, 16-byte aligned {r.dtype} tensor "
                         f"of r's shape {tuple(r.shape)}")
    if dstate_out is not None and (
            dstate_out.shape != state.shape or dstate_out.dtype != torch.float32
            or dstate_out.device != r.device or not dstate_out.is_contiguous()
            or dstate_out.data_ptr() % 16):
        raise ValueError(f"dstate_out must be a contiguous, 16-byte aligned float32 "
                         f"tensor of the state's shape {tuple(state.shape)}")
    dr, dk, dv, dw = (torch.empty_like(x) for x in (r, k, v, w))
    du, dstate = torch.empty_like(u), torch.empty_like(state)
    f32 = dict(dtype=torch.float32, device=r.device)
    ckpt = torch.empty(b * h * (-(-t // BWD_CHUNK) - 1) * kk * kk, **f32)
    du_part = torch.empty(b * h * kk, **f32)
    err = _build.library().repro_wkv6_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        state.data_ptr(), dy.data_ptr(),
        None if dstate_out is None else dstate_out.data_ptr(),
        dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(),
        dstate.data_ptr(), ckpt.data_ptr(), du_part.data_ptr(),
        b, t, h, kk, _DTYPE_CODE[r.dtype], torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(err, "wkv6_backward")
    _build.count_launch(wkv6_backward)
    return dr, dk, dv, dw, du, dstate


def _wkv6_impl(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor,
               state: Tensor) -> Tuple[Tensor, Tensor]:
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, state)
    return _forward(r, k, v, w, u, state)


def _wkv6_bwd_impl(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor, state: Tensor,
                   dy: Tensor, dstate_out: Optional[Tensor]
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    return _backward(r, k, v, w, u, state, dy, dstate_out)


_wkv6_op = torch.library.custom_op("repro::wkv6", _wkv6_impl, mutates_args=())
_wkv6_bwd_op = torch.library.custom_op("repro::wkv6_backward", _wkv6_bwd_impl,
                                       mutates_args=())


@_wkv6_op.register_fake
def _(r, k, v, w, u, state):
    return torch.empty_like(r), torch.empty_like(state)


@_wkv6_bwd_op.register_fake
def _(r, k, v, w, u, state, dy, dstate_out):
    return (*(torch.empty_like(x) for x in (r, k, v, w, u)), torch.empty_like(state))


@register_flop_formula(torch.ops.repro.wkv6)
def _wkv6_flops(r_shape, *args, **kwargs) -> int:
    """Per step and head: y = r (S + u k v^T), 2 K^2, and the state's
    update w S + k v^T, 2 K^2."""
    b, t, h, kk = r_shape
    return 4 * b * t * h * kk * kk


@register_flop_formula(torch.ops.repro.wkv6_backward)
def _wkv6_bwd_flops(r_shape, *args, **kwargs) -> int:
    """Per step and head: the state again (2 K^2), dr, the state's gradient
    carried back, and dk, dv and dw from it (2 K^2 each)."""
    b, t, h, kk = r_shape
    return 12 * b * t * h * kk * kk


class _WKV6(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient (on the
    card, or on fake tensors: a real CPU tensor differentiates ``wkv6_ref``).
    A gradient that does not reach y or the final state comes as None and is
    taken as zero."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, state)
        return _build.entry(_wkv6_op, _wkv6_impl, r)(r, k, v, w, u, state)

    @staticmethod
    def backward(ctx, dy, dstate_out):
        r, k, v, w, u, state = ctx.saved_tensors
        dy = torch.zeros_like(r) if dy is None else dy.contiguous()
        grads = _build.entry(_wkv6_bwd_op, _wkv6_bwd_impl, r)(
            r, k, v, w, u, state, dy, None if dstate_out is None else dstate_out.contiguous())
        return (*grads[:5], grads[5] if ctx.needs_input_grad[5] else None)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: [B,T,H,K]; u: [H,K]; state: [B,H,K,K] float32 (row k,
    column v).  Returns (y [B,T,H,K] in r.dtype, final state float32).  A
    gradient flows to every input through ``wkv6_backward``."""
    _check(r, k, v, w, u, state)
    if r.device.type == "cpu" and not _build.is_fake(r):
        return wkv6_ref(r, k, v, w, u, state)
    return _WKV6.apply(r, k, v, w, u, state)


def wkv6_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                  u: torch.Tensor, state: torch.Tensor, dy: torch.Tensor,
                  dstate_out: Optional[torch.Tensor] = None):
    """(dr, dk, dv, dw, du, dstate) of ``wkv6(r, k, v, w, u, state)`` for the
    output gradient ``dy`` (r's type and shape) and the final state's
    gradient ``dstate_out`` (float32, zero when None): the gradients in
    their inputs' types, dstate in float32.  On the CPU ``wkv6_bwd_ref``.
    Deterministic on the card (no atomics)."""
    _check(r, k, v, w, u, state)
    return _build.entry(_wkv6_bwd_op, _wkv6_bwd_impl, r)(r, k, v, w, u, state, dy, dstate_out)


wkv6.launches = 0
wkv6_backward.launches = 0

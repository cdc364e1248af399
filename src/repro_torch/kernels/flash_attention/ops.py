"""Public flash-attention wrapper: [B,S,H,D] layout, native GQA, float32 or
bfloat16, differentiable.

A tensor on the CPU goes to the plain versions (``ref.attention_ref``
forward, ``ref.attention_bwd_ref`` backward); a tensor on the card launches
the CUDA kernels of its type or raises, all on the tensor cores: the
forward (float32 as three TF32 products: ``csrc/flash_attention.cu``;
bfloat16: ``csrc/flash_attention_bf16.cu``) and the backward (float32, again
3xTF32: ``csrc/flash_attention_bwd.cu``; bfloat16:
``csrc/flash_attention_bwd_bf16.cu``), the backward from the log-sum-exp
that the forward of either type stores when a gradient is wanted.
``flash_attention.launches`` counts the forward kernel's launches and
``flash_attention_backward.launches`` the backward's (one per call, either
type), and nothing else.

The forward (with and without the log-sum-exp) and the backward are custom
ops (``torch.ops.repro.flash_attention``, ``flash_attention_lse``,
``flash_attention_backward``), whose implementation is the device switch
above: a fake tensor (the dry-run's) takes their fake implementation, which
gives the outputs' shapes and launches nothing, and a flop formula counts
their work (``torch.utils.flop_counter``).  A real tensor with no dispatch
mode active skips the op's dispatch and runs its body (``_build.entry``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
#: Where its (b, h, query tile) dQ blocks would not fill the card's SMs, the
#: backward (either type) splits each query tile's key range over this many
#: dQ blocks an SM (float32 partials, summed in a fixed order), at least 2
#: tiles of 64 keys each.
DQ_BLOCKS_PER_SM = 2


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
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"{name} is {t.dtype}, q {q.dtype}; the kernel "
                            f"takes float32 or bfloat16, the same for all")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if b * h > 65535 or sq == 0 or sk == 0:
        raise ValueError(f"shape B*H={b * h}, Sq={sq}, Sk={sk} not supported")


def _forward(q, k, v, causal: bool, scale: float, lse=None) -> torch.Tensor:
    """The forward; ``lse``, a float32 [B,H,Sq] tensor on the card, is
    filled by the kernel (either type) with each row's log-sum-exp."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, sm_scale=scale)
    (b, sq, h, d), (sk, kv) = q.shape, k.shape[1:3]
    o = torch.empty_like(q)
    lib = _build.library()
    entry = (lib.repro_flash_attention_bf16 if q.dtype == torch.bfloat16
             else lib.repro_flash_attention_f32)
    err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                None if lse is None else lse.data_ptr(), b, h, kv, sq, sk, d, int(causal),
                scale, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    _build.count_launch(flash_attention)
    return o


def dq_splits(b: int, h: int, sq: int, sk: int, sms: int) -> int:
    """Parts the backward (either type) cuts each query tile's key range
    into: 1 where its B H ceil(Sq / 64) dQ blocks fill ``sms`` SMs, else
    enough for DQ_BLOCKS_PER_SM dQ blocks an SM, at least 2 of the
    ceil(Sk / 64) tiles of 64 keys each (the float32 kernel at D 128 steps
    through them 32 keys at a time)."""
    blocks, k_tiles = b * h * -(-sq // 64), -(-sk // 64)
    if blocks >= sms:
        return 1
    per = max(2, -(-k_tiles // -(-DQ_BLOCKS_PER_SM * sms // blocks)))
    return -(-k_tiles // per)


def _backward(q, k, v, o, do, causal: bool, scale: float, lse=None):
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, do, causal=causal, sm_scale=scale, lse=lse)
    (b, sq, h, d), (sk, kv) = q.shape, k.shape[1:3]
    for name, t in (("o", o), ("do", do)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{q.dtype} tensor of q's shape {tuple(q.shape)}")
    if (lse is None or lse.shape != (b, h, sq) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError("the backward kernel needs the forward's log-sum-exp, a "
                         f"contiguous float32 [{b}, {h}, {sq}] tensor on q's device "
                         "(flash_attention_with_lse)")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    splits = dq_splits(b, h, sq, sk,
                       torch.cuda.get_device_properties(q.device).multi_processor_count)
    stats = torch.empty(2 * b * h * sq, dtype=torch.float32, device=q.device)
    part = (torch.empty(splits * q.numel(), dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    lib = _build.library()
    entry = (lib.repro_flash_attention_bwd_bf16 if q.dtype == torch.bfloat16
             else lib.repro_flash_attention_bwd)
    err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
                None if part is None else part.data_ptr(), b, h, kv, sq, sk, d, int(causal),
                splits, scale, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_backward")
    _build.count_launch(flash_attention_backward)
    return dq, dk, dv


def _lse_like(q: Tensor) -> Tensor:
    return torch.empty(q.shape[0], q.shape[2], q.shape[1], dtype=torch.float32,
                       device=q.device)


def _flash_impl(q: Tensor, k: Tensor, v: Tensor, causal: bool, scale: float) -> Tensor:
    return _forward(q, k, v, causal, scale)


def _flash_lse_impl(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                    scale: float) -> Tuple[Tensor, Tensor]:
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, sm_scale=scale, return_lse=True)
    lse = _lse_like(q)
    return _forward(q, k, v, causal, scale, lse), lse


def _flash_bwd_impl(q: Tensor, k: Tensor, v: Tensor, o: Tensor, do: Tensor, causal: bool,
                    scale: float, lse: Optional[Tensor]) -> Tuple[Tensor, Tensor, Tensor]:
    return _backward(q, k, v, o, do, causal, scale, lse)


_flash_op = torch.library.custom_op("repro::flash_attention", _flash_impl, mutates_args=())
_flash_lse_op = torch.library.custom_op("repro::flash_attention_lse", _flash_lse_impl,
                                        mutates_args=())
_flash_bwd_op = torch.library.custom_op("repro::flash_attention_backward", _flash_bwd_impl,
                                        mutates_args=())


@_flash_op.register_fake
def _(q, k, v, causal, scale):
    return torch.empty_like(q)


@_flash_lse_op.register_fake
def _(q, k, v, causal, scale):
    return torch.empty_like(q), _lse_like(q)


@_flash_bwd_op.register_fake
def _(q, k, v, o, do, causal, scale, lse):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _pairs(sq: int, sk: int, causal: bool) -> int:
    """Query-key pairs the kernel computes (a causal kernel skips the tiles
    above the diagonal)."""
    return sq * (sq + 1) // 2 if causal else sq * sk


@register_flop_formula([torch.ops.repro.flash_attention, torch.ops.repro.flash_attention_lse])
def _flash_flops(q_shape, k_shape, v_shape, causal, scale, *args, **kwargs) -> int:
    """S = Q K^T and O = P V: two products of 2 d flops a pair."""
    b, sq, h, d = q_shape
    return 4 * b * h * _pairs(sq, k_shape[1], causal) * d


@register_flop_formula(torch.ops.repro.flash_attention_backward)
def _flash_bwd_flops(q_shape, k_shape, v_shape, o_shape, do_shape, causal, *args,
                     **kwargs) -> int:
    """S again, dP = dO V^T, dV = P^T dO, dQ = dS K and dK = dS^T Q: five
    products of 2 d flops a pair."""
    b, sq, h, d = q_shape
    return 10 * b * h * _pairs(sq, k_shape[1], causal) * d


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient; on the
    CPU both plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        lse = None
        if q.device.type == "cuda" and any(ctx.needs_input_grad):
            o, lse = _build.entry(_flash_lse_op, _flash_lse_impl, q)(q, k, v, causal, scale)
        else:
            o = _build.entry(_flash_op, _flash_impl, q)(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        run = _build.entry(_flash_bwd_op, _flash_bwd_impl, q)
        return (*run(q, k, v, o, do.contiguous(), ctx.causal, ctx.scale, lse), None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, sm_scale=None) -> torch.Tensor:
    """q: [B,Sq,H,D]; k, v: [B,Sk,KV,D] with H % KV == 0 (GQA without
    repeats).  Non-causal allows Sq != Sk; causal needs Sq == Sk.  Keys past
    Sk are masked inside the kernel, so nothing is padded.  A gradient
    flows to q, k and v through ``flash_attention_backward``."""
    _check(q, k, v, causal)
    scale = float(sm_scale) if sm_scale is not None else q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, causal, scale)


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             causal: bool = False, sm_scale=None):
    """(o, lse): ``flash_attention``'s output, without autograd, and each
    row's float32 log-sum-exp of the scaled, masked scores, [B,H,Sq], as the
    backward takes it.  On the card the forward kernel (either type) stores
    it in the same launch; on the CPU both come from ``attention_ref``.
    Inputs that need a gradient are refused under grad mode on either device
    (``flash_attention`` differentiates)."""
    _build.refuse_grad("flash_attention_with_lse", q, k, v)
    _check(q, k, v, causal)
    scale = float(sm_scale) if sm_scale is not None else q.shape[-1] ** -0.5
    return _build.entry(_flash_lse_op, _flash_lse_impl, q)(q, k, v, causal, scale)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = False, sm_scale=None, lse=None):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` = ``o`` for the output
    gradient ``do`` [B,Sq,H,D]; dk and dv sum over each kv head's group of
    query heads.  ``lse`` is the forward's log-sum-exp
    (`flash_attention_with_lse`): the kernel (either type) needs it and
    raises without it, the CPU uses it where given.  Deterministic on the
    card (no atomics)."""
    _check(q, k, v, causal)
    scale = float(sm_scale) if sm_scale is not None else q.shape[-1] ** -0.5
    return _build.entry(_flash_bwd_op, _flash_bwd_impl, q)(q, k, v, o, do, causal, scale, lse)


flash_attention.launches = 0
flash_attention_backward.launches = 0

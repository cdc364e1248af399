"""Public flash-decode wrappers: GQA query groups against a float or an
int8 KV cache, in either cache layout.

  decode_attention_grouped / decode_attention_int8_grouped — q [B,KV,G,D];
      the two kernels' wrappers, with ``seq_axis`` naming the layout
  decode_attention / decode_attention_quantized — q [B,H,D], cache
      [B,S,KV,D] (the JAX package's kernel-native layout)
  decode_attention_cache / decode_attention_int8_cache — q [B,H,D], cache
      [B,KV,S,D] (the serving layout the model keeps)

A tensor on the CPU goes to the plain version (``ref.py``); a tensor on the
card launches the CUDA kernel (``csrc/decode_attention.cu``) or raises, and
raises too under grad mode when an input needs a gradient (the kernel has
no backward).
``cur_index`` is an int, a 0-d tensor or a [B] vector of last valid
positions (>= 0); it is handed over as an int32 [B] tensor, on the card
without a host sync.  ``decode_attention_grouped.launches`` and
``decode_attention_int8_grouped.launches`` count kernel launches and
nothing else.

Both kernels' entries are custom ops (``torch.ops.repro.decode_attention``,
``decode_attention_int8``), whose implementation is the device switch above;
a fake tensor (the dry-run's) takes their fake implementation, and a flop
formula counts their work.  A real tensor with no dispatch mode active skips
the op's dispatch and runs its body (``_build.entry``).  ``decode_attention_lse`` and
``decode_attention_int8_lse`` give each row's log-sum-exp beside its output
(float32 [B,KV,G]; -inf, and an output of zeros, where the row has no
position at or before its index, which ``cur_index`` < 0 asks for), read
from the kernel's own partials: a cache sharded over its sequence combines
its shards' outputs by them, as the kernel combines its splits.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention.ref import (
    decode_int8_lse_ref,
    decode_int8_ref,
    decode_lse_ref,
    decode_ref,
)

HEAD_DIMS = (32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


#: (cache element bytes, D) -> cache positions per split block, as the
#: library reports it; read once per pair
_CHUNKS: dict = {}


def _chunk(elem_bytes: int, d: int) -> int:
    key = (elem_bytes, d)
    if key not in _CHUNKS:
        _CHUNKS[key] = _build.library().repro_decode_attention_chunk(elem_bytes, d)
    return _CHUNKS[key]


def _cur_vector(cur_index, b: int, device: torch.device) -> torch.Tensor:
    if isinstance(cur_index, torch.Tensor):
        cur = cur_index.to(device=device, dtype=torch.int32)
        return cur.reshape(-1).expand(b).contiguous()
    return torch.full((b,), int(cur_index), dtype=torch.int32, device=device)


def _check_cache(q, named, seq_axis: int, dtype):
    """Shapes, devices, types and alignment the kernel needs; returns
    (S, stride_b, stride_kv, stride_s) of the cache in elements."""
    b, kv, g, d = q.shape
    k = named[0][1]
    s = k.shape[seq_axis]
    want = (b, s, kv, d) if seq_axis == 1 else (b, kv, s, d)
    for name, t in named:
        if tuple(t.shape) != want:
            raise ValueError(f"{name} {tuple(t.shape)} does not match q "
                             f"{tuple(q.shape)} (expected {want})")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes {dtype}")
        if t.stride() != k.stride() or t.stride(-1) != 1 or t.data_ptr() % 16:
            raise ValueError(f"{name} must share k's strides, with a "
                             f"contiguous, 16-byte aligned head dimension")
        if any(st % (16 // t.element_size()) for st in t.stride()[:-1]):
            raise ValueError(f"{name}'s strides {t.stride()} break vector loads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if not q.is_contiguous() or b * kv * g == 0 or s == 0:
        raise ValueError(f"q {tuple(q.shape)} must be contiguous and non-empty")
    if b > 65535 or kv * ((g + 3) // 4) > 65535:
        raise ValueError(f"B={b}, KV={kv}, G={g} exceed the launch grid")
    kv_axis = 2 if seq_axis == 1 else 1
    return s, k.stride(0), k.stride(kv_axis), k.stride(seq_axis)


def _partials(q, cache, s: int):
    b, kv, g, d = q.shape
    n_split = -(-s // _chunk(cache.element_size(), d))
    acc = torch.empty(b * kv * g * n_split * d, dtype=torch.float32, device=q.device)
    ml = torch.empty(b * kv * g * n_split * 2, dtype=torch.float32, device=q.device)
    return acc, ml


def _check_device(q):
    if q.device.type != "cuda" or q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q is {q.dtype} on {q.device}; the kernel takes "
                        f"float32 or bfloat16 on a CUDA device")


def _launch(q, k_cache, v_cache, cur, seq_axis: int):
    """The fp kernel -> (out, its partials' (m, l) [B*KV*G, n_split, 2])."""
    s, sb, skv, ss = _check_cache(q, (("k_cache", k_cache), ("v_cache", v_cache)),
                                  seq_axis, q.dtype)
    b, kv, g, d = q.shape
    out = torch.empty_like(q)
    acc, ml = _partials(q, k_cache, s)
    err = _build.library().repro_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cur.data_ptr(),
        out.data_ptr(), acc.data_ptr(), ml.data_ptr(), b, kv, g, s, d, sb, skv,
        ss, _DTYPE_CODE[q.dtype], d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention")
    _build.count_launch(decode_attention_grouped)
    return out, ml.view(b * kv * g, -1, 2)


def _launch_int8(q, k_q, v_q, k_scale, v_scale, cur, seq_axis: int):
    """The int8 kernel -> (out, its partials' (m, l))."""
    s, sb, skv, ss = _check_cache(q, (("k_q", k_q), ("v_q", v_q)), seq_axis,
                                  torch.int8)
    b, kv, g, d = q.shape
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if (tuple(t.shape) != (b, kv, s) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 [B,KV,S] = "
                             f"{(b, kv, s)} tensor on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty_like(q)
    acc, ml = _partials(q, k_q, s)
    err = _build.library().repro_decode_attention_int8(
        q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), cur.data_ptr(), out.data_ptr(), acc.data_ptr(),
        ml.data_ptr(), b, kv, g, s, d, sb, skv, ss, _DTYPE_CODE[q.dtype],
        d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention_int8")
    _build.count_launch(decode_attention_int8_grouped)
    return out, ml.view(b * kv * g, -1, 2)


def _lse_of_partials(ml: Tensor, q: Tensor, cur: Tensor, s: int, elem_bytes: int) -> Tensor:
    """Each row's log-sum-exp from the split kernel's (m, l) of the chunks
    up to its index (later chunks are never written): M + log sum_j l_j
    e^(m_j - M), -inf for a row with no valid position."""
    b, kv, g, d = q.shape
    chunk = _chunk(elem_bytes, d)
    last = torch.where(cur < 0, -1, torch.clamp(cur, max=s - 1) // chunk)      # [B]
    valid = (torch.arange(ml.shape[1], device=q.device)[None, :]
             <= last[:, None]).repeat_interleave(kv * g, dim=0)               # [R, n]
    m = torch.where(valid, ml[..., 0], float("-inf"))
    mx = m.amax(dim=-1, keepdim=True)
    mx_safe = torch.where(torch.isfinite(mx), mx, 0.0)
    tot = torch.where(valid, ml[..., 1] * torch.exp(m - mx_safe), 0.0).sum(dim=-1)
    return (mx_safe[:, 0] + torch.log(tot)).view(b, kv, g)


def _decode_impl(q: Tensor, k_cache: Tensor, v_cache: Tensor, cur: Tensor,
                 seq_axis: int) -> Tensor:
    if q.device.type == "cpu":
        return decode_ref(q, k_cache, v_cache, cur, seq_axis=seq_axis)
    _check_device(q)
    return _launch(q, k_cache, v_cache, cur, seq_axis)[0]


def _decode_lse_impl(q: Tensor, k_cache: Tensor, v_cache: Tensor, cur: Tensor,
                     seq_axis: int) -> Tuple[Tensor, Tensor]:
    if q.device.type == "cpu":
        return decode_lse_ref(q, k_cache, v_cache, cur, seq_axis=seq_axis)
    _check_device(q)
    out, ml = _launch(q, k_cache, v_cache, cur, seq_axis)
    return out, _lse_of_partials(ml, q, cur, k_cache.shape[seq_axis], k_cache.element_size())


def _decode_int8_impl(q: Tensor, k_q: Tensor, v_q: Tensor, k_scale: Tensor,
                      v_scale: Tensor, cur: Tensor, seq_axis: int) -> Tensor:
    if q.device.type == "cpu":
        return decode_int8_ref(q, k_q, v_q, k_scale, v_scale, cur, seq_axis=seq_axis)
    _check_device(q)
    return _launch_int8(q, k_q, v_q, k_scale, v_scale, cur, seq_axis)[0]


def _decode_int8_lse_impl(q: Tensor, k_q: Tensor, v_q: Tensor, k_scale: Tensor,
                          v_scale: Tensor, cur: Tensor, seq_axis: int
                          ) -> Tuple[Tensor, Tensor]:
    if q.device.type == "cpu":
        return decode_int8_lse_ref(q, k_q, v_q, k_scale, v_scale, cur, seq_axis=seq_axis)
    _check_device(q)
    out, ml = _launch_int8(q, k_q, v_q, k_scale, v_scale, cur, seq_axis)
    return out, _lse_of_partials(ml, q, cur, k_q.shape[seq_axis], 1)


_decode_op = torch.library.custom_op("repro::decode_attention", _decode_impl,
                                     mutates_args=())
_decode_lse_op = torch.library.custom_op("repro::decode_attention_lse", _decode_lse_impl,
                                         mutates_args=())
_decode_int8_op = torch.library.custom_op("repro::decode_attention_int8",
                                          _decode_int8_impl, mutates_args=())
_decode_int8_lse_op = torch.library.custom_op("repro::decode_attention_int8_lse",
                                              _decode_int8_lse_impl, mutates_args=())


def _fake_out(q, *args):
    return torch.empty_like(q)


def _fake_out_lse(q, *args):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


for _op, _fake in ((_decode_op, _fake_out), (_decode_int8_op, _fake_out),
                   (_decode_lse_op, _fake_out_lse), (_decode_int8_lse_op, _fake_out_lse)):
    _op.register_fake(_fake)


@register_flop_formula([torch.ops.repro.decode_attention, torch.ops.repro.decode_attention_lse,
                        torch.ops.repro.decode_attention_int8,
                        torch.ops.repro.decode_attention_int8_lse])
def _decode_flops(q_shape, k_shape, *args, **kwargs) -> int:
    """The scores and P V over the whole cache (the kernel's blocks past the
    index exit at once, but the roofline counts the cache a decode reads at
    its longest): two products of 2 D flops a position and query row."""
    b, kv, g, d = q_shape
    s = k_shape[args[-1]]
    return 4 * b * kv * g * s * d


def decode_attention_grouped(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, cur_index, *,
                             seq_axis: int = 2) -> torch.Tensor:
    """q [B,KV,G,D]; k/v cache [B,KV,S,D] (seq_axis 2) or [B,S,KV,D]
    (seq_axis 1), float32 or bfloat16 like q -> [B,KV,G,D] in q's type."""
    if q.device.type == "cuda":
        _build.refuse_grad("decode_attention", q, k_cache, v_cache)
    run = _build.entry(_decode_op, _decode_impl, q)
    return run(q, k_cache, v_cache, _cur_vector(cur_index, q.shape[0], q.device), seq_axis)


def decode_attention_grouped_lse(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, cur_index, *,
                                 seq_axis: int = 2) -> Tuple[Tensor, Tensor]:
    """``decode_attention_grouped`` -> (out, each row's log-sum-exp [B,KV,G]
    float32); an index < 0 gives zeros and -inf."""
    if q.device.type == "cuda":
        _build.refuse_grad("decode_attention", q, k_cache, v_cache)
    run = _build.entry(_decode_lse_op, _decode_lse_impl, q)
    return run(q, k_cache, v_cache, _cur_vector(cur_index, q.shape[0], q.device), seq_axis)


def decode_attention_int8_grouped(q: torch.Tensor, k_q: torch.Tensor,
                                  v_q: torch.Tensor, k_scale: torch.Tensor,
                                  v_scale: torch.Tensor, cur_index, *,
                                  seq_axis: int = 2) -> torch.Tensor:
    """q [B,KV,G,D] float32 or bfloat16; int8 k/v in either layout; float32
    scales [B,KV,S] -> [B,KV,G,D] in q's type."""
    if q.device.type == "cuda":
        _build.refuse_grad("decode_attention_int8", q, k_q, v_q, k_scale, v_scale)
    run = _build.entry(_decode_int8_op, _decode_int8_impl, q)
    return run(q, k_q, v_q, k_scale, v_scale, _cur_vector(cur_index, q.shape[0], q.device),
               seq_axis)


def decode_attention_int8_grouped_lse(q: torch.Tensor, k_q: torch.Tensor,
                                      v_q: torch.Tensor, k_scale: torch.Tensor,
                                      v_scale: torch.Tensor, cur_index, *,
                                      seq_axis: int = 2) -> Tuple[Tensor, Tensor]:
    """``decode_attention_int8_grouped`` -> (out, each row's log-sum-exp)."""
    if q.device.type == "cuda":
        _build.refuse_grad("decode_attention_int8", q, k_q, v_q, k_scale, v_scale)
    run = _build.entry(_decode_int8_lse_op, _decode_int8_lse_impl, q)
    return run(q, k_q, v_q, k_scale, v_scale, _cur_vector(cur_index, q.shape[0], q.device),
               seq_axis)


decode_attention_grouped.launches = 0
decode_attention_int8_grouped.launches = 0


def _grouped(q: torch.Tensor, kv: int) -> torch.Tensor:
    b, h, d = q.shape
    if h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} kv heads")
    return q.reshape(b, kv, h // kv, d)


def decode_attention(q, k_cache, v_cache, cur_index):
    """q [B,H,D]; k/v cache [B,S,KV,D] -> [B,H,D]."""
    out = decode_attention_grouped(_grouped(q, k_cache.shape[2]), k_cache,
                                   v_cache, cur_index, seq_axis=1)
    return out.reshape(q.shape)


def decode_attention_cache(q, k_cache, v_cache, cur_index):
    """Serving layout: q [B,H,D]; k/v cache [B,KV,S,D] -> [B,H,D]."""
    out = decode_attention_grouped(_grouped(q, k_cache.shape[1]), k_cache,
                                   v_cache, cur_index, seq_axis=2)
    return out.reshape(q.shape)


def decode_attention_quantized(q, k_q, v_q, k_scale, v_scale, cur_index):
    """q [B,H,D]; int8 k/v [B,S,KV,D]; scales [B,KV,S] -> [B,H,D]."""
    out = decode_attention_int8_grouped(_grouped(q, k_q.shape[2]), k_q, v_q,
                                        k_scale, v_scale, cur_index, seq_axis=1)
    return out.reshape(q.shape)


def decode_attention_int8_cache(q, k_q, v_q, k_scale, v_scale, cur_index):
    """Serving layout: q [B,H,D]; int8 k/v [B,KV,S,D]; scales [B,KV,S]."""
    out = decode_attention_int8_grouped(_grouped(q, k_q.shape[1]), k_q, v_q,
                                        k_scale, v_scale, cur_index, seq_axis=2)
    return out.reshape(q.shape)

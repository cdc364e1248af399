"""Plain PyTorch versions of the flash-decode kernels.

The same functions as the kernels in ``csrc/decode_attention.cu``: scores
and softmax in float32 with q scaled by D^-0.5 first, positions past
``cur_index`` masked, the output in q's type.  The int8 version multiplies
the scores by the k scales and the probabilities by the v scales before the
PV product, as the kernel does.  The CPU path of the wrappers runs them; on
the card they are what the kernels are held against.

``decode_chunked_ref`` emulates the kernel's order instead: fixed chunks of
``chunk_len`` positions, each with its own (m, l, acc), combined in
ascending chunk order.  Only the tests use it.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
#: bytes of K rows a split block of the kernel holds (``TILE_BYTES`` in
#: csrc/decode_attention.cu; a card test holds the two equal)
TILE_BYTES = 32768


def chunk_len(elem_bytes: int, d: int) -> int:
    """Cache positions per split block of the kernel: 128 of bfloat16 at D
    128, 256 of int8, 64 of float32."""
    return TILE_BYTES // (d * elem_bytes)


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


def _with_lse(out: torch.Tensor, sc: torch.Tensor, valid: torch.Tensor):
    """(out with the rows that see no position zeroed, each row's
    log-sum-exp of its valid scores, -inf where there is none)."""
    lse = torch.logsumexp(sc.masked_fill(~valid[:, None, None, :], float("-inf")), dim=-1)
    seen = valid.any(dim=-1)[:, None, None]
    return torch.where(seen[..., None], out, torch.zeros_like(out)), lse


def decode_lse_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                   cur_index, *, seq_axis: int = 2):
    """``decode_ref`` -> (out, lse [B,KV,G] float32): the output of a row
    with no position at or before its index (``cur_index`` < 0) is zeros and
    its log-sum-exp -inf, as the kernel's partials give them."""
    k = _serving_layout(k_cache, seq_axis)
    b, _, _, d = q.shape
    sc = torch.einsum("bngd,bntd->bngt", q.float() * d ** -0.5, k.float())
    valid = _valid(cur_index, b, k.shape[2], q.device)
    return _with_lse(decode_ref(q, k_cache, v_cache, cur_index, seq_axis=seq_axis),
                     sc, valid)


def decode_int8_lse_ref(q: torch.Tensor, k_q: torch.Tensor, v_q: torch.Tensor,
                        k_scale: torch.Tensor, v_scale: torch.Tensor, cur_index, *,
                        seq_axis: int = 2):
    """``decode_int8_ref`` -> (out, lse), as ``decode_lse_ref``."""
    k = _serving_layout(k_q, seq_axis)
    b, _, _, d = q.shape
    sc = torch.einsum("bngd,bntd->bngt", q.float() * d ** -0.5,
                      k.float()) * k_scale[:, :, None, :]
    valid = _valid(cur_index, b, k.shape[2], q.device)
    out = decode_int8_ref(q, k_q, v_q, k_scale, v_scale, cur_index, seq_axis=seq_axis)
    return _with_lse(out, sc, valid)


def quantize_kv(cache: torch.Tensor):
    """[B,S,KV,D] float -> (int8 [B,S,KV,D], float32 scales [B,KV,S]):
    absmax per (position, head), as the JAX package's ``quantize_kv``."""
    absmax = cache.float().abs().amax(dim=-1)                    # [B,S,KV]
    scale = torch.clamp(absmax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(cache.float() / scale[..., None]),
                    -127, 127).to(torch.int8)
    return q, scale.transpose(1, 2).contiguous()


def decode_chunked_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cur_index,
                       *, seq_axis: int = 2, k_scale=None, v_scale=None,
                       chunk: int = 0) -> torch.Tensor:
    """The kernel's order in plain PyTorch: per row, chunks of ``chunk``
    positions (the kernel's ``chunk_len`` by default) up to cur_index, each
    with its max m, sum l and unnormalised acc, then
    out = sum_j acc_j e^(m_j - M) / sum_j l_j e^(m_j - M), the sums taken
    in ascending chunk order.  A float cache, or an int8 one with both
    scales [B,KV,S].  -> [B,KV,G,D] in q's type."""
    k, v = _serving_layout(k, seq_axis), _serving_layout(v, seq_axis)
    b, _, _, d = q.shape
    s = k.shape[2]
    chunk = chunk or chunk_len(k.element_size(), d)
    qf = q.float() * d ** -0.5
    cur = torch.as_tensor(cur_index).reshape(-1).expand(b).tolist()
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for r, c in enumerate(cur):
        c = min(c, s - 1)
        parts = []
        for start in range(0, c + 1, chunk):
            end = min(start + chunk, c + 1)
            sc = torch.einsum("ngd,ntd->ngt", qf[r], k[r, :, start:end].float())
            if k_scale is not None:
                sc = sc * k_scale[r, :, None, start:end]
            m = sc.amax(dim=-1)
            p = torch.exp(sc - m[..., None])
            l = p.sum(dim=-1)
            if v_scale is not None:
                p = p * v_scale[r, :, None, start:end]
            parts.append((m, l, torch.einsum("ngt,ntd->ngd", p, v[r, :, start:end].float())))
        if not parts:
            continue
        mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        l, acc = torch.zeros_like(mx), torch.zeros_like(out[r])
        for m, lj, aj in parts:
            w = torch.exp(m - mx)
            l = l + lj * w
            acc = acc + aj * w[..., None]
        out[r] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)

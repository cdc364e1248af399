"""Shared model layers: RMS norm, RoPE, head projections, attention (causal
and non-causal flash prefill, flash-decode over a float or an int8 cache,
sliding-window attention and the ring-cache decode), the per-token int8
quantizer, the SwiGLU MLP, the DDIM update and the chunked cross-entropy
loss of the training path.

The path is chosen by the tensor's device and nothing else: a CUDA tensor
goes through the hand-written kernels in ``repro_torch.kernels`` (which
launch or raise), a CPU tensor through their plain PyTorch versions.  There
is no switch that sends a CUDA tensor to the plain version.

Sliding-window attention (``window > 0``, gemma3's local layers) is plain
PyTorch on every device, as it is plain jnp in the JAX package, whose flash
kernel is only taken at ``window == 0``; the ring-cache decode of a local
layer runs through the flash-decode kernel (``models/transformer.py``), and
``attention_decode_ring`` is the plain port of the JAX function it is held
against.

Under a partitioner (``models/param.py``) the kernels run on each rank's
shards through ``local_map`` (``repro_torch.sharding.local``): the flash
kernel with heads over ``model``, flash-decode over a cache sharded along
its sequence, combined by log-sum-exp; so do the embedding lookup, the
head projections, the MLP and the row-wise ops, whose layouts DTensor
cannot find alone.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import (
    ddim_step,
    decode_attention_grouped,
    decode_attention_int8_grouped,
    flash_attention,
)
from repro_torch.kernels.decode_attention import (
    decode_attention_grouped_lse,
    decode_attention_int8_grouped_lse,
)
from repro_torch.models.param import constrain
from repro_torch.sharding import local as shard_local

NEG_INF = -1e30


#: PyTorch's CUDA reduction sets how many lanes share one row's sum by the
#: number of rows, up to 16 (``setReduceConfig`` in ATen's Reduce.cuh), and
#: so a row's summation order: a decode step of one request at batch 1 would
#: norm its activations in another order than the same request in a slot
#: batch of 8, and its tokens could drift apart.  Means over the last axis
#: are therefore taken over at least this many rows (zero rows padded).
MIN_REDUCE_ROWS = 16


def row_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis, keepdim, with a summation order that does
    not depend on how many rows ``x`` has (``MIN_REDUCE_ROWS``); sharded, on
    each rank's rows."""
    if shard_local.sharded(x):
        return shard_local.row_mean(_row_mean, x)
    return _row_mean(x)


def _row_mean(x: torch.Tensor) -> torch.Tensor:
    rows = x.reshape(-1, x.shape[-1])
    n = rows.shape[0]
    if n < MIN_REDUCE_ROWS:
        rows = F.pad(rows, (0, 0, 0, MIN_REDUCE_ROWS - n))
    return rows.mean(dim=-1)[:n].reshape(*x.shape[:-1], 1)


#: cuBLAS picks a product's algorithm by its shape, and with it the order in
#: which a row's sum is taken: a skinny product (few outputs, a long sum)
#: it splits along the sum by the number of rows, so a request decoded alone
#: and in a slot batch of 8 would round apart.  A decode step's products
#: that must not depend on the batch run on blocks of exactly this many
#: rows, zero-padded (``row_blocks_matmul``).
ROW_BLOCK = 16


def row_blocks_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over blocks of exactly ``ROW_BLOCK`` rows of x [..., D],
    zero-padded; sharded, over each rank's rows."""
    if shard_local.sharded(x):
        return shard_local.rows(_row_blocks_matmul, (x,), (w,))
    return _row_blocks_matmul(x, w)


def _row_blocks_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    rows = x.reshape(-1, x.shape[-1])
    n = rows.shape[0]
    rows = F.pad(rows, (0, 0, 0, -n % ROW_BLOCK))
    blocks = [blk @ w for blk in rows.split(ROW_BLOCK)]
    out = blocks[0] if len(blocks) == 1 else torch.cat(blocks)
    return out[:n].reshape(*x.shape[:-1], w.shape[-1])


def per_row_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, S, D] @ w [D, N], each batch row's result as it would be alone:
    a decode step's rows (S == 1) in ``row_blocks_matmul``, a longer
    sequence row by row, so that every product has the same shape at any
    batch size; sharded, over each rank's rows."""
    if shard_local.sharded(x):
        return shard_local.rows(_per_row_matmul, (x,), (w,))
    return _per_row_matmul(x, w)


def _per_row_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.shape[1] == 1:
        return _row_blocks_matmul(x, w)
    return torch.cat([x[i:i + 1] @ w for i in range(x.shape[0])])


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  Sharded, laid out with the sequence whole (batch as
    the rules split it): a later layout that splits the sequence sends its
    gradient back through that one, so that the lookup's backward (a sum
    over flattened [B*S] rows) never meets a split sequence, which DTensor
    cannot flatten.  The lookup runs on each rank's shards
    (``sharding.local.embed``: DTensor's own lookup differentiates through
    an index_put that some versions cannot place)."""
    if shard_local.sharded(table):
        return constrain(shard_local.embed(table, tokens), "batch", "seq", "act_embed")
    return table[tokens]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Scales by ``1 + w``, in float32."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(row_mean(x * x) + eps)
    return (x * (1.0 + w.float())).to(dt)


def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float,
               rotary_dim: int = 0):
    """positions [...] -> (sin, cos) of shape [..., rotary_dim // 2]."""
    rd = rotary_dim or head_dim
    exps = torch.arange(0, rd, 2, dtype=torch.float32,
                        device=positions.device) / rd
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=positions.device), exps)
    ang = positions.float()[..., None] * inv
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
               rotary_dim: int = 0) -> torch.Tensor:
    """x [B,S,H,hd]; sin/cos [B,S,rd/2] or [S,rd/2].  Rotates the first rd
    dims as interleaved pairs and passes the rest through."""
    rd = rotary_dim or x.shape[-1]
    if sin.dim() == 2:  # [S, rd/2] -> [1,S,1,rd/2]
        sin, cos = sin[None, :, None, :], cos[None, :, None, :]
    else:  # [B,S,rd/2] -> [B,S,1,rd/2]
        sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    rot = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([rot, xp], dim=-1) if rd < x.shape[-1] else rot


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B,S,D] @ w [D,H,hd] -> contiguous [B,S,H,hd]; sharded, on each
    rank's shards (``sharding.local.project_heads``)."""
    if shard_local.sharded(x):
        return shard_local.project_heads(_project_heads, x, w)
    return _project_heads(x, w)


def _project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    return (x @ w.reshape(w.shape[0], -1)).view(b, s, w.shape[1], w.shape[2])


def merge_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B,S,H,hd] @ w [H,hd,D] -> [B,S,D]; sharded, on each rank's
    shards (``sharding.local.merge_heads``)."""
    if shard_local.sharded(x):
        return shard_local.merge_heads(_merge_heads, x, w)
    return _merge_heads(x, w)


def _merge_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    b, s = x.shape[:2]
    return x.reshape(b, s, -1) @ w.reshape(-1, w.shape[-1])


def _masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q0: int, k0: int, causal: bool, window: int) -> torch.Tensor:
    """Plain attention of queries at positions q0.. over keys at k0..:
    q [B,Sq,H,hd], k/v [B,Sk,KV,hd] -> [B,Sq,H,hd].  Scores and softmax in
    float32, the probabilities in q's type, as the JAX package's reference
    branch computes them."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, d) * d ** -0.5
    sc = torch.einsum("bsngd,btnd->bngst", qg, k).float()
    qpos = q0 + torch.arange(sq, device=q.device)[:, None]
    kpos = k0 + torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= kpos > qpos - window
    pr = torch.softmax(sc.masked_fill(~mask, NEG_INF), dim=-1).to(q.dtype)
    return torch.einsum("bngst,btnd->bsngd", pr, v).reshape(b, sq, h, d)


def attention_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B,Sq,H,hd]; k, v: [B,Sk,KV,hd] -> [B,Sq,H,hd], through the flash
    kernel; causal needs Sq == Sk.  With a window, key t is seen from query
    s where s - window < t (and t <= s if causal), in plain PyTorch."""
    if window:
        return _on_shards(partial(_masked_attention, q0=0, k0=0, window=window), q, k, v,
                          causal)
    return _on_shards(flash_attention, q, k, v, causal)


def _on_shards(attend: Callable, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool) -> torch.Tensor:
    """``attend(q, k, v, causal=)`` (the flash kernel, or a windowed plain
    attention), on each rank's shards when q is sharded."""
    if shard_local.sharded(q):
        return shard_local.attention(attend, q, k, v, causal)
    return attend(q, k, v, causal=causal)


def attention_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_block: int = 512) -> torch.Tensor:
    """The JAX package's memory-safe attention for long prompts (S > 2048).
    Without a window it is the flash kernel, which never forms the [S, S]
    scores.  With one (always causal, as in the JAX package) each block of
    ``q_block`` queries (halved until it divides S) attends over a span of
    ``window + q_block`` keys ending at its last query, so a local layer
    costs O(S * window), in plain PyTorch."""
    if not window:
        return _on_shards(flash_attention, q, k, v, causal)
    return _on_shards(partial(_windowed_blocks, window=window, q_block=q_block), q, k, v,
                      True)


def _windowed_blocks(q, k, v, causal: bool, window: int, q_block: int) -> torch.Tensor:
    s = q.shape[1]
    q_block = min(q_block, s)
    while s % q_block:
        q_block //= 2
    span = min(window + q_block, s)
    out = []
    for qs in range(0, s, q_block):
        start = min(max(qs + q_block - span, 0), s - span)
        out.append(_masked_attention(q[:, qs:qs + q_block], k[:, start:start + span],
                                     v[:, start:start + span], qs, start, causal,
                                     window))
    return torch.cat(out, dim=1)


def _group(q: torch.Tensor, kv: int) -> torch.Tensor:
    b, h, d = q.shape
    return q.reshape(b, kv, h // kv, d)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_index) -> torch.Tensor:
    """One new token per row against the serving-layout cache.  q [B,H,hd];
    k/v cache [B,KV,Smax,hd]; cur_index an int (lockstep batch) or a [B]
    tensor (one position per slot).  -> [B,H,hd] through the flash-decode
    kernel, for both forms of the index."""
    if shard_local.sharded(q):
        return shard_local.decode(decode_attention_grouped_lse, q, (k_cache, v_cache),
                                  cur_index)
    out = decode_attention_grouped(_group(q, k_cache.shape[1]), k_cache,
                                   v_cache, cur_index)
    return out.reshape(q.shape)


def attention_decode_ring(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, cur_index) -> torch.Tensor:
    """Decode attention over a sliding-window ring cache, in plain PyTorch:
    q [B,H,hd]; k/v ring [B,KV,W,hd], where slot j holds absolute position
    cur - ((cur - j) mod W); a slot whose position would be negative is
    not yet written.  cur_index an int or a [B] tensor."""
    b, h, d = q.shape
    kv, w = k_cache.shape[1], k_cache.shape[2]
    qg = _group(q, kv) * d ** -0.5
    sc = torch.einsum("bngd,bntd->bngt", qg, k_cache).float()
    cur = torch.as_tensor(cur_index, device=q.device).reshape(-1, 1)
    slots = torch.arange(w, device=q.device)[None, :]
    valid = (cur - torch.remainder(cur - slots, w) >= 0).expand(b, w)
    sc = sc.masked_fill(~valid[:, None, None, :], NEG_INF)
    pr = torch.softmax(sc, dim=-1).to(q.dtype)
    return torch.einsum("bngt,bntd->bngd", pr, v_cache).reshape(b, h, d)


def quantize_token_kv(x: torch.Tensor):
    """x [B,KV,T,hd] -> (int8 values, float32 scales [B,KV,T]): absmax per
    (head, token)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def attention_decode_int8(q: torch.Tensor, k_q: torch.Tensor, v_q: torch.Tensor,
                          k_s: torch.Tensor, v_s: torch.Tensor,
                          cur_index) -> torch.Tensor:
    """int8-cache decode: q [B,H,hd]; int8 k/v [B,KV,Smax,hd]; float32
    scales [B,KV,Smax]; the scales fold into the scores (k) and the
    probabilities (v) inside the kernel."""
    if shard_local.sharded(q):
        return shard_local.decode(decode_attention_int8_grouped_lse, q,
                                  (k_q, v_q, k_s, v_s), cur_index)
    out = decode_attention_int8_grouped(_group(q, k_q.shape[1]), k_q, v_q,
                                        k_s, v_s, cur_index)
    return out.reshape(q.shape)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """Sharded, on each rank's shards as a column- then row-parallel MLP
    (``sharding.local.mlp``)."""
    if shard_local.sharded(x):
        return shard_local.mlp(_swiglu, x, (w_gate, w_up), w_down)
    return _swiglu(x, w_gate, w_up, w_down)


def _swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    h = constrain(h, "batch", "seq", "act_mlp")
    return h @ w_down


def ddim_update(x: torch.Tensor, eps: torch.Tensor, alpha_t,
                alpha_prev) -> torch.Tensor:
    """One deterministic (eta = 0) DDIM update, fused into ``c1*x + c2*eps``
    with host-side float32 coefficients (``repro_torch.kernels.ddim_step``)."""
    return ddim_step(x, eps, alpha_t, alpha_prev)


def _ce_sum(h: torch.Tensor, unembed: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Summed cross entropy of one chunk: h [B,C,D] -> float32 logits.
    Sharded, the gold logit is a masked sum over the vocabulary (one term
    and zeros: the gathered value), which needs no gather across the
    vocabulary's shards."""
    logits = (h @ unembed).float()
    logits = constrain(logits, "batch", "seq", "act_vocab")
    if shard_local.sharded(logits):
        ids = torch.arange(logits.shape[-1], device=labels.device)
        gold = torch.where(ids == labels[..., None].long(), logits, 0.0).sum(dim=-1)
    else:
        gold = logits.gather(-1, labels[..., None].long())[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def chunked_cross_entropy(hidden: torch.Tensor, unembed: torch.Tensor,
                          labels: torch.Tensor, *, chunk: int = 512) -> torch.Tensor:
    """Mean cross entropy over B*S of ``hidden`` [B,S,D] @ ``unembed``
    [D,V] against ``labels`` [B,S], without the [B,S,V] logits: the sequence
    in chunks of ``chunk`` positions (halved until it divides S), each under
    ``torch.utils.checkpoint`` so that its float32 logits are recomputed in
    the backward and never saved, as the JAX package's checkpointed scan."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    # sharded, the sequence whole before it is cut into chunks
    hidden = constrain(hidden, "batch", "seq", "act_embed")
    labels = constrain(labels, "batch", "seq")
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, chunk):
        tot = tot + checkpoint(_ce_sum, hidden[:, i:i + chunk], unembed,
                               labels[:, i:i + chunk], use_reentrant=False)
    return tot / (b * s)

"""The kernels, and the products DTensor cannot lay out alone, on each
rank's shards: each call site runs its function through ``local_map``, so
that the kernel (or, on the CPU, its plain version) sees the plain tensors
of one rank, as the JAX package's ``shard_map`` hands them to its Pallas
kernels.

  sharded(x)             whether ``x`` runs sharded: a DTensor under an
                         ambient partitioner
  attention(...)         the flash kernel, or a windowed layer's plain
                         attention, with heads over ``model``; a shard's
                         query heads read the kv heads they map to in the
                         whole model
  decode(...)            flash-decode over a cache whose sequence is sharded:
                         each shard's output and log-sum-exp, combined over
                         the sequence's mesh axes by log-sum-exp
  wkv6(...)              the WKV6 recurrence with heads over ``model``
  ssd(...)               Mamba2's SSD recurrence with heads over ``model``
  write_prompt / write_token   the cache writes of prefill and decode,
                         each shard writing the positions it holds
  embed, project_heads, merge_heads, mlp, row_mean, rows
                         the lookup, the attention's column- and
                         row-parallel products, the MLP and the row-wise
                         ops whose views would flatten two split dims (a
                         strided split, which DTensor redistributes in
                         hundreds of small ops or refuses) or split a head

Every function here takes and returns DTensors.  A gradient placement is
a partial sum over the mesh dims where another operand is split.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from repro_torch.models.param import current_partitioner, is_dtensor


def sharded(x) -> bool:
    return current_partitioner() is not None and is_dtensor(x)


def _local_map(fn, out_placements, in_placements, mesh, in_grad_placements=None):
    """``fn`` on each rank's shards, its inputs redistributed to
    ``in_placements`` first."""
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=in_grad_placements, device_mesh=mesh,
                     redistribute_inputs=True)


def _shard_dims(placements, dim: int) -> list:
    """The mesh dims whose placement shards tensor dim ``dim``, in mesh
    order (the outer first)."""
    from torch.distributed.tensor import Shard

    return [i for i, p in enumerate(placements) if isinstance(p, Shard) and p.dim == dim]


def shard_offset(mesh, placements, dim: int, local_size: int) -> int:
    """Where this rank's shard of tensor dim ``dim`` starts (even shards)."""
    idx = 0
    for i in _shard_dims(placements, dim):
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx * local_size


def _like(placements, keep: Sequence[int]) -> tuple:
    """Placements that keep the Shards of tensor dims ``keep`` and
    replicate the rest."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(p if isinstance(p, Shard) and p.dim in keep else Replicate()
                 for p in placements)


# ------------------------------------------------- products on the stream
def _is_shard(p, dim: int) -> bool:
    from torch.distributed.tensor import Shard

    return isinstance(p, Shard) and p.dim == dim


def _even(x, placements) -> tuple:
    """``placements`` for x with every uneven split replicated: a dim whose
    size its mesh axes do not divide (DTensor's own propagation can split
    one so; ``local_map`` rebuilds its outputs as even splits)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    uneven = {d for d in range(x.dim())
              if x.shape[d] % math.prod(mesh.size(i) for i in _shard_dims(placements, d))}
    return tuple(Replicate() if isinstance(p, Shard) and p.dim in uneven else p
                 for p in placements)


def _keep(placements, dim: int) -> tuple:
    """Only the Shards of tensor dim ``dim`` kept; the rest replicated."""
    return _like(placements, (dim,))


def row_mean(fn: Callable, x):
    """``fn(x)``, a mean over x's last dim (keepdim), on each rank's rows:
    the last dim whole, the other dims split as they are (a view that
    flattened two split dims would give DTensor a strided split)."""
    from torch.distributed.tensor import Replicate, Shard

    last = x.dim() - 1
    pl = _even(x, tuple(p if isinstance(p, Shard) and p.dim != last else Replicate()
                        for p in x.placements))
    return _local_map(fn, list(pl), (pl,), x.device_mesh)(x)


def rows(fn: Callable, xs: Sequence, ws: Sequence, outputs: int = 1):
    """``fn(*xs, *ws)`` on each rank's rows: every x [B, ...] with the first
    x's batch split and whole elsewhere, every w whole; each of the
    ``outputs`` outputs [B, ...] split by batch.  The ws' gradients are
    partial sums over the batch shards.  (A product whose rows must not
    depend on the batch, ``layers.row_blocks_matmul``; rwkv6's token-shift
    mix and decay, whose products DTensor would lay out op by op.)"""
    from torch.distributed.tensor import Partial, Replicate

    xp = _even(xs[0], _keep(xs[0].placements, 0))
    wp = tuple(Replicate() for _ in xp)
    w_grad = tuple(Partial() if _is_shard(a, 0) else b for a, b in zip(xp, wp))
    out = list(xp) if outputs == 1 else (xp,) * outputs
    return _local_map(fn, out, (xp,) * len(xs) + (wp,) * len(ws), xs[0].device_mesh,
                      (xp,) * len(xs) + (w_grad,) * len(ws))(*xs, *ws)


def mlp(fn: Callable, x, w_in: Sequence, w_out):
    """``fn(x, *w_in, w_out)``, an MLP x [B,S,D] -> [B,S,D] whose inner
    width is w_in's last dim and w_out's first, on each rank's shards as
    column- then row-parallel products: x with its batch split as it is
    and whole elsewhere, the inner width split as the weights split it (their
    FSDP shards over the embedding gathered); the output is split by batch
    and a partial sum over the inner width's shards.  The gradients are
    partial sums where the other operands are split."""
    from torch.distributed.tensor import Partial, Replicate

    xp = _even(x, _keep(x.placements, 0))
    wps = [_keep(w.placements, 1) for w in w_in] + [_keep(w_out.placements, 0)]
    inner = [any(not isinstance(wp[i], Replicate) for wp in wps) for i in range(len(xp))]
    out = [Partial() if f else a for a, f in zip(xp, inner)]
    x_grad = tuple(Partial() if f else a for a, f in zip(xp, inner))
    w_grads = [tuple(Partial() if _is_shard(a, 0) else b for a, b in zip(xp, wp))
               for wp in wps]
    return _local_map(fn, out, (xp, *wps), x.device_mesh, (x_grad, *w_grads))(
        x, *w_in, w_out)


# -------------------------------------------------------------- attention
def project_heads(fn: Callable, x, w):
    """``fn(x, w)``, x [B,S,D] @ w [D,H,hd] -> [B,S,H,hd], on each rank's
    shards as a column-parallel product: x with its batch split as it is and
    whole elsewhere, w with its heads split as they are and whole elsewhere
    (its FSDP shards over the embedding gathered), the output split by both.
    The gradients are partial sums where the other operand is split: x's
    over the head shards, w's over the batch shards.  (DTensor alone may
    split the product's columns inside a head, which no view to heads can
    take.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard

    xp, wp = _even(x, _keep(x.placements, 0)), _keep(w.placements, 1)
    out = [Shard(0) if _is_shard(a, 0) else (Shard(2) if _is_shard(b, 1) else Replicate())
           for a, b in zip(xp, wp)]
    x_grad = tuple(Partial() if _is_shard(b, 1) else a for a, b in zip(xp, wp))
    w_grad = tuple(Partial() if _is_shard(a, 0) else b for a, b in zip(xp, wp))
    return _local_map(fn, out, (xp, wp), x.device_mesh, (x_grad, w_grad))(x, w)


def _kv_slice(kl: torch.Tensor, vl: torch.Tensor, h: int, kv: int, hl: int, rank: int):
    """With query heads sharded and kv heads whole, the kv heads that this
    shard's ``hl`` query heads (from ``rank * hl`` on) map to."""
    if kl.shape[2] != kv or hl == h:
        return kl, vl
    g = h // kv
    if hl % g and g % hl:
        raise NotImplementedError(f"{hl} query heads a shard do not group over kv "
                                  f"groups of {g}")
    lo, hi = rank * hl // g, ((rank + 1) * hl - 1) // g + 1
    return kl[:, :, lo:hi].contiguous(), vl[:, :, lo:hi].contiguous()


def embed(table, tokens):
    """``table[tokens]`` on each rank's shards, vocabulary-parallel: the
    table [V,D] keeps its vocabulary split (its FSDP shards over D
    gathered), the tokens their batch split; a rank looks up the tokens in
    its range and gives zeros elsewhere, so the output is a partial sum over
    the vocabulary's shards (as DTensor's own masked lookup).  The table's
    gradient is a partial sum over the batch shards."""
    from torch.distributed.tensor import Partial, Replicate

    mesh = table.device_mesh
    tp = _keep(table.placements, 0)
    ip = _even(tokens, _keep(tokens.placements, 0))
    split = math.prod(mesh.size(i) for i, p in enumerate(tp) if _is_shard(p, 0))
    out = [Partial() if _is_shard(a, 0) else (b if _is_shard(b, 0) else Replicate())
           for a, b in zip(tp, ip)]
    t_grad = tuple(Partial() if _is_shard(b, 0) else a for a, b in zip(tp, ip))

    def local(tl, ids):
        if split == 1:
            return tl[ids]
        lo = shard_offset(mesh, tp, 0, tl.shape[0])
        inside = (ids >= lo) & (ids < lo + tl.shape[0])
        got = tl[(ids - lo).clamp(0, tl.shape[0] - 1)]
        return torch.where(inside[..., None], got, torch.zeros((), dtype=got.dtype,
                                                                device=got.device))

    return _local_map(local, out, (tp, ip), mesh, (t_grad, ip))(table, tokens)


def merge_heads(fn: Callable, att, w):
    """``fn(att, w)``, att [B,S,H,hd] @ w [H,hd,D] -> [B,S,D], on each rank's
    shards as a row-parallel product: att with its batch and heads split as
    they are, w with its heads split as they are and whole elsewhere; the
    output split by batch and a partial sum over the head shards.  w's
    gradient is a partial sum over the batch shards.  (DTensor alone would
    flatten the output's gradient over a split sequence in the backward.)"""
    from torch.distributed.tensor import Partial, Replicate

    ap, wp = _even(att, _like(att.placements, (0, 2))), _keep(w.placements, 0)
    out = [Partial() if _is_shard(b, 0) else (a if _is_shard(a, 0) else Replicate())
           for a, b in zip(ap, wp)]
    w_grad = tuple(Partial() if _is_shard(a, 0) else b for a, b in zip(ap, wp))
    return _local_map(fn, out, (ap, wp), att.device_mesh, (ap, w_grad))(att, w)


def attention(attend: Callable, q, k, v, causal: bool):
    """``attend(q, k, v, causal=)`` (the flash kernel, or the windowed
    layers' plain attention) on each rank's shards: q, k, v [B,S,H,hd] with
    batch over ("pod", "data") and heads over ``model`` where they divide.
    Where the kv heads do not divide over ``model`` (qwen3-1.7b's 8 kv heads
    on 16), each shard reads the kv heads its query heads map to."""
    part = current_partitioner()
    mesh = part.mesh
    logical = ("batch", "seq", "act_heads", None)
    qp, kp = part.placements(q.shape, logical), part.placements(k.shape, logical)
    h, kv = q.shape[2], k.shape[2]

    def local(ql, kl, vl):
        rank = mesh.get_local_rank("model") if "model" in mesh.mesh_dim_names else 0
        kl, vl = _kv_slice(kl, vl, h, kv, ql.shape[2], rank)
        return attend(ql.contiguous(), kl.contiguous(), vl.contiguous(), causal=causal)

    # whole kv heads read in slices: their gradient sums the slices' over model
    from torch.distributed.tensor import Partial

    kv_grad = tuple(Partial() if _is_shard(a, 2) and not _is_shard(b, 2) else b
                    for a, b in zip(qp, kp))
    return _local_map(local, list(qp), (qp, kp, kp), mesh, (qp, kv_grad, kv_grad))(q, k, v)


def _cache_placements(cache0):
    """For a cache leaf [B,KV,S,hd]: (the query's placements, [B,H,hd] or
    [B,KV,G,hd]: batch and heads as the cache's batch and kv heads, the
    rest replicated; the mesh dims of the cache's sequence)."""
    pl = tuple(cache0.placements)
    return _like(pl, (0, 1)), _shard_dims(pl, 2)


def _combine(out: torch.Tensor, lse: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shards' (out [B,KV,G,hd], lse [B,KV,G]) gathered over ``group`` and
    combined in rank order: out = sum_i e^(lse_i - M) out_i / sum_i
    e^(lse_i - M).  A shard that saw no position has lse -inf and weighs 0."""
    from torch.distributed import _functional_collectives as funcol

    gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
    outs = gather(out.float().contiguous(), 0, group).view(-1, *out.shape)
    lses = gather(lse.contiguous(), 0, group).view(-1, *lse.shape)
    mx = lses.amax(dim=0)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    w = torch.exp(lses - mx)
    tot = w.sum(dim=0)
    comb = (w[..., None] * outs).sum(dim=0) / torch.clamp(tot, min=1e-30)[..., None]
    return comb.to(out.dtype), mx + torch.log(tot)


def decode(decode_lse: Callable, q, cache: tuple, cur_index):
    """Flash-decode of q [B,H,hd] over ``cache`` (k, v[, k_scale, v_scale]),
    each [B,KV,S,...], on each rank's shards: the query's heads whole, the
    batch and kv heads as the cache's; a shard holding positions off..off+S'
    attends to those up to the index (``cur_index`` - off, < 0 where it
    holds none), and the shards' outputs are combined by log-sum-exp over
    the mesh axes the sequence is sharded on.  ``decode_lse(q [B,KV,G,hd],
    *cache, cur) -> (out, lse)``.  -> [B,H,hd]."""
    part = current_partitioner()
    mesh = part.mesh
    b, h, d = q.shape
    kv = cache[0].shape[1]
    qp, seq_dims = _cache_placements(cache[0])
    # the heads split over kv groups as the cache's kv heads are split
    qg = q.redistribute(mesh, qp).reshape(b, kv, h // kv, d)
    cps = tuple(tuple(c.placements) for c in cache)
    cur_t = isinstance(cur_index, torch.Tensor)

    def local(ql, *cl):
        s_loc = cl[0].shape[2]
        off = shard_offset(mesh, cps[0], 2, s_loc)
        if cur_t:
            b_off = shard_offset(mesh, cps[0], 0, ql.shape[0])
            cur = cur_index.to(ql.device)[b_off:b_off + ql.shape[0]] - off
        else:
            cur = cur_index - off
        out, lse = decode_lse(ql.contiguous(), *cl, cur)
        for i in reversed(seq_dims):     # the inner axis first
            if mesh.size(i) > 1:
                out, lse = _combine(out, lse, (mesh, i))
        return out

    out = _local_map(local, list(qp), (qp, *cps), mesh)(qg, *cache)
    return out.reshape(b, h, d)


def _write(cache: tuple, srcs: tuple, col) -> None:
    """Each shard writes ``srcs`` (the new positions [B,KV,T,...] of every
    cache leaf, brought to the cache's batch and kv-head layout and whole
    along the sequence) at the global positions ``col`` that fall in its
    range, in place: a slice (the prompt, from 0), an int, or a [B] tensor
    (clamped to the last position, as the unsharded write clamps it)."""
    mesh = cache[0].device_mesh
    pl = tuple(cache[0].placements)
    cl = [c.to_local() for c in cache]
    sl = [x.redistribute(mesh, _like(tuple(c.placements), (0, 1))).to_local()
          for x, c in zip(srcs, cache)]
    s_loc = cl[0].shape[2]
    off = shard_offset(mesh, pl, 2, s_loc)
    if isinstance(col, slice):
        lo, hi = off, min(off + s_loc, sl[0].shape[2])
        for dst, src in zip(cl, sl):
            if lo < hi:
                dst[:, :, :hi - lo] = src[:, :, lo:hi]
    elif isinstance(col, torch.Tensor):
        b_off = shard_offset(mesh, pl, 0, cl[0].shape[0])
        c = col.to(cl[0].device, torch.long).clamp(max=cache[0].shape[2] - 1)
        c = c[b_off:b_off + cl[0].shape[0]] - off
        rows = torch.nonzero((c >= 0) & (c < s_loc))[:, 0]
        for dst, src in zip(cl, sl):
            dst[rows, :, c[rows]] = src[rows, :, 0].to(dst.dtype)
    elif off <= col < off + s_loc:
        for dst, src in zip(cl, sl):
            dst[:, :, col - off] = src[:, :, 0].to(dst.dtype)


def write_prompt(cache: tuple, srcs: tuple) -> None:
    """Prefill: ``srcs`` [B,KV,T,...] at positions 0..T-1."""
    _write(cache, srcs, slice(0, None))


def write_token(cache: tuple, srcs: tuple, cur_index) -> None:
    """Decode: ``srcs`` [B,KV,1,...] at each row's ``cur_index``."""
    _write(cache, srcs, cur_index)


# -------------------------------------------------------------------- wkv6
def wkv6(fn: Callable, r, k, v, w, u, state):
    """``fn(r, k, v, w, u, state)`` on each rank's shards: batch over ("pod",
    "data"), heads over ``model`` (``ssm_heads``)."""
    part = current_partitioner()
    x = part.placements(r.shape, ("batch", "seq", "ssm_heads", None))
    up = part.placements(u.shape, ("ssm_heads", None))
    sp = part.placements(state.shape, ("batch", "ssm_heads", None, None))

    def local(*xs):
        return fn(*(t.contiguous() for t in xs))

    # u is read by every batch shard: its gradient sums theirs
    from torch.distributed.tensor import Partial

    u_grad = tuple(Partial() if _is_shard(a, 0) else b for a, b in zip(x, up))
    return _local_map(local, (x, sp), (x, x, x, x, up, sp), part.mesh,
                      (x, x, x, x, u_grad, sp))(r, k, v, w, u, state)


# --------------------------------------------------------------------- ssd
def ssd(fn: Callable, x, dt, la, B, C, state):
    """``fn(x, dt, la, B, C, state)``, Mamba2's SSD recurrence over a
    sequence, on each rank's shards: batch over ("pod", "data"), heads over
    ``model`` (``ssm_heads``); B and C [B,T,N] have no head dim and are
    whole but for the batch, read by every head shard: their gradient sums
    the head shards'.  (DTensor alone would propagate op by op through each
    chunk's products.)"""
    part = current_partitioner()
    xp = part.placements(x.shape, ("batch", "seq", "ssm_heads", None))
    hp = part.placements(dt.shape, ("batch", "seq", "ssm_heads"))
    bp = part.placements(B.shape, ("batch", "seq", None))
    sp = part.placements(state.shape, ("batch", "ssm_heads", None, None))

    def local(*xs):
        return fn(*(t.contiguous() for t in xs))

    from torch.distributed.tensor import Partial

    b_grad = tuple(Partial() if _is_shard(a, 2) else b for a, b in zip(xp, bp))
    return _local_map(local, (xp, sp), (xp, hp, hp, bp, bp, sp), part.mesh,
                      (xp, hp, hp, b_grad, b_grad, sp))(x, dt, la, B, C, state)

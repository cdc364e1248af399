"""Mixture-of-Experts FFN: a float32 router, the capacity dispatch and the
dropless path, with the JAX package's names and arithmetic.

  moe_param_specs          the expert leaves of a layer stack
  moe_ffn                  top-k routing with a per-expert capacity: the
                           assignments past it are dropped (the JAX
                           package's single-device branch)
  moe_ffn_dense_fallback   dropless: every token through its top-k experts
                           under a one-hot gate over all experts; what the
                           serving engine runs

Under a partitioner (``models/param.py``) ``moe_ffn`` takes the JAX
package's sharded branch, its ``shard_map`` as ``local_map``: tokens stay
over ("pod", "data") and each rank routes and dispatches its own tokens, in
chunks of about 8k local tokens (one ``torch.utils.checkpoint`` each while
training), through a d_ff slice of every expert over ``model``; the d_ff
partials are summed over ``model`` (a ``Partial`` placement, reduced where
the next op needs it).  The load-balancing loss is the global one: the
shards' weighted mean probabilities and counts are summed over the mesh.
The dropless path has no sharded branch, as in the JAX package.

No Pallas kernel is involved, in the JAX package or here: the expert
products are batched matrix products over the expert axis, ``[E,T,d] @
[E,d,F]``, that read each weight where it lies (an einsum of the form
``td,edf->tef`` may copy every ``[E,d,F]`` weight into another order first).

Rows and batch width.  A served stream must equal its solo ``generate``,
so a decode step's row must not see how many rows its batch has, and cuBLAS
may split a sum differently for 1 row than for 8 (the skinny router,
64 or 40 columns, is the kind of product where it did for rwkv6).  The
dropless path therefore pads the token rows to a multiple of ``ROW_BLOCK``:
every decode step of up to 16 slots runs its router, expert and combine
products at one shape, whatever the slot count.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import ParamSpec, current_partitioner, is_dtensor

Tree = Dict[str, Any]

#: token rows of the dropless path are padded to a multiple of this
ROW_BLOCK = 16


def moe_param_specs(cfg: ModelConfig, n_layers: int, dtype: str) -> Tree:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "moe_norm": ParamSpec((n_layers, d), ("layers", "embed"), dtype, "zeros"),
        "router": ParamSpec((n_layers, d, e), ("layers", "embed", None), "float32"),
        "we_gate": ParamSpec((n_layers, e, d, f), ("layers", None, "embed", "mlp"), dtype),
        "we_up": ParamSpec((n_layers, e, d, f), ("layers", None, "embed", "mlp"), dtype),
        "we_down": ParamSpec((n_layers, e, f, d), ("layers", None, "mlp", "embed"), dtype),
    }
    if cfg.num_shared_experts:
        fs = cfg.num_shared_experts * f
        p["ws_gate"] = ParamSpec((n_layers, d, fs), ("layers", "embed", "mlp"), dtype)
        p["ws_up"] = ParamSpec((n_layers, d, fs), ("layers", "embed", "mlp"), dtype)
        p["ws_down"] = ParamSpec((n_layers, fs, d), ("layers", "mlp", "embed"), dtype)
    return p


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    cap = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, (cap + 7) // 8 * 8)


def _pad_rows(x: torch.Tensor) -> torch.Tensor:
    """x [T, ...] with zero rows appended up to a multiple of ROW_BLOCK."""
    return F.pad(x, (0, 0) * (x.dim() - 1) + (0, -x.shape[0] % ROW_BLOCK))


def _top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index, as
    ``jax.lax.top_k`` breaks them (``torch.topk`` promises no order)."""
    w, i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], i[..., :k]


def _route(x: torch.Tensor, router: torch.Tensor, cfg: ModelConfig):
    """x [B,S,D] -> (top_w [B,S,k] float32, top_i [B,S,k] int64, the mean
    probability of each expert [E], the assignments each expert got [E]):
    float32 logits, softmax and the top k renormalised.  The logits' product
    runs on rows padded to ``ROW_BLOCK``."""
    b, s, d = x.shape
    t, e = b * s, cfg.num_experts
    rows = _pad_rows(x.reshape(t, d).float())
    logits = (rows @ router)[:t].reshape(b, s, e)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = _top_k(probs, cfg.top_k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    counts = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, top_i.reshape(-1), torch.ones(t * cfg.top_k, device=x.device))
    return top_w, top_i, probs.mean(dim=(0, 1)), counts


def _aux(me: torch.Tensor, counts: torch.Tensor, n_tokens: int, cfg: ModelConfig):
    """The load-balancing loss E * sum(me * ce), ce the share of the
    assignments each expert got."""
    ce = counts / (n_tokens * cfg.top_k)
    return cfg.num_experts * torch.sum(me * ce)


def _router(x: torch.Tensor, lp: Tree, cfg: ModelConfig):
    """x [B,S,D] -> (top_w [B,S,k] float32, top_i [B,S,k] int64, aux loss)."""
    top_w, top_i, me, counts = _route(x, lp["router"], cfg)
    return top_w, top_i, _aux(me, counts, x.shape[0] * x.shape[1], cfg)


def _experts(h: torch.Tensor, we_gate, we_up, we_down) -> torch.Tensor:
    """The experts' SwiGLU, batched over the expert axis: h [E,R,d] (or
    [R,d], every expert on the same rows) -> [E,R,d]."""
    if h.dim() == 2:
        h = h.expand(we_gate.shape[0], *h.shape)
    return torch.bmm(F.silu(torch.bmm(h, we_gate)) * torch.bmm(h, we_up), we_down)


def _shared(xf: torch.Tensor, lp: Tree) -> torch.Tensor:
    return (F.silu(xf @ lp["ws_gate"]) * (xf @ lp["ws_up"])) @ lp["ws_down"]


def _dispatch_compute(x, top_w, top_i, lp: Tree, cfg: ModelConfig) -> torch.Tensor:
    """The capacity dispatch: x [B,S,D] -> [B,S,D].  Assignments sorted by
    expert (a stable sort, as ``jnp.argsort`` is), each expert's first
    ``_capacity`` kept and the rest sent to a trash row, the experts run on
    their [E, cap, D] buffers, and each token's k weighted outputs summed
    (a dropped one is zero) in a fixed order."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.num_experts, cfg.top_k
    xf = x.reshape(t, d)
    cap = _capacity(t, cfg)
    dev = x.device

    flat_e = top_i.reshape(-1)                                    # [T*k]
    order = torch.argsort(flat_e, stable=True)
    seg = flat_e[order]
    src_tok = order // k
    starts = torch.searchsorted(seg, torch.arange(e, device=dev))
    pos_in_seg = torch.arange(t * k, device=dev) - starts[seg]
    keep = pos_in_seg < cap
    slot = torch.where(keep, seg * cap + pos_in_seg, torch.full_like(seg, e * cap))

    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=dev)
    buf[slot] = xf[src_tok]
    y = _experts(buf[:e * cap].reshape(e, cap, d), lp["we_gate"], lp["we_up"],
                 lp["we_down"])
    yflat = torch.cat([y.reshape(e * cap, d), torch.zeros((1, d), dtype=x.dtype,
                                                          device=dev)])
    w_sorted = top_w.reshape(t * k)[order].to(x.dtype)
    # each kept assignment's weighted output back in assignment order, then
    # a token's k summed in that order: no atomic adds, so the same inputs
    # give the same bits on the card
    per = torch.empty((t * k, d), dtype=x.dtype, device=dev)
    per[order] = yflat[slot] * w_sorted[:, None]
    out = per.view(t, k, d).sum(dim=1)
    if cfg.num_shared_experts:
        out = out + _shared(xf, lp)
    return out.reshape(b, s, d)


#: local tokens a chunk of the sharded dispatch holds at most, about
CHUNK_TOKENS = 8192
EXPERT_LEAVES = ("we_gate", "we_up", "we_down")
SHARED_LEAVES = ("ws_gate", "ws_up", "ws_down")
#: each leaf's logical axes in the sharded branch: d_ff over ``model``
_LOCAL_AXES = {"we_gate": (None, None, "mlp"), "we_up": (None, None, "mlp"),
               "we_down": (None, "mlp", None), "ws_gate": (None, "mlp"),
               "ws_up": (None, "mlp"), "ws_down": ("mlp", None)}


def n_chunks(b_loc: int, s_loc: int) -> int:
    """Chunks of the local sequence, so that a chunk holds about
    ``CHUNK_TOKENS`` of the b_loc * s_loc local tokens (the JAX package's
    rule: the largest count up to that which divides s_loc)."""
    for cand in range(max(1, (b_loc * s_loc) // CHUNK_TOKENS), 0, -1):
        if s_loc % cand == 0:
            return cand
    return 1


def _moe_sharded(x: torch.Tensor, lp: Tree, cfg: ModelConfig, part):
    """The sharded branch: x a DTensor [B,S,D] -> ([B,S,D], aux).  Two
    ``local_map`` regions, as the JAX package routes outside its
    ``shard_map``: the routing, on each rank's tokens and the same on every
    ``model`` rank; then the dispatch through each ``model`` rank's d_ff
    slice, whose outputs, and whose gradients for x and the routing
    weights, are partial sums over ``model``."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = part.mesh
    tok = part.placements(x.shape, ("batch", None, None))
    names = [k for k in SHARED_LEAVES if cfg.num_shared_experts] + list(EXPERT_LEAVES)
    wpl = [part.placements(lp[k].shape, _LOCAL_AXES[k]) for k in names]
    f_sharded = any(p.is_shard() for p in wpl[-1])
    n_tot = x.shape[0] * x.shape[1]
    # sums over the token shards; d_ff partials over model
    tok_sum = tuple(Partial() if p.is_shard() else Replicate() for p in tok)
    part_f = tuple(Partial() if (n == "model" and f_sharded) else p
                   for n, p in zip(mesh.mesh_dim_names, tok))
    rep = tuple(Replicate() for _ in tok)

    def route(xl, router):
        top_w, top_i, me, counts = _route(xl, router, cfg)
        return top_w, top_i, me * (xl.shape[0] * xl.shape[1] / n_tot), counts

    top_w, top_i, me, counts = local_map(
        route, out_placements=(tok, tok, tok_sum, tok_sum), in_placements=(tok, rep),
        in_grad_placements=(tok, tok_sum), device_mesh=mesh,
        redistribute_inputs=True)(x, lp["router"])

    def dispatch(xl, twl, til, *ws):
        b_loc, s_loc, _ = xl.shape
        wl = dict(zip(names, ws))
        k = n_chunks(b_loc, s_loc)
        sc = s_loc // k
        outs = []
        for i in range(k):
            args = (xl[:, i * sc:(i + 1) * sc], twl[:, i * sc:(i + 1) * sc],
                    til[:, i * sc:(i + 1) * sc], wl, cfg)
            outs.append(checkpoint(_dispatch_compute, *args, use_reentrant=False)
                        if torch.is_grad_enabled() else _dispatch_compute(*args))
        return outs[0] if k == 1 else torch.cat(outs, dim=1)

    w_grads = [tuple(Partial() if t.is_shard() else w for t, w in zip(tok, wp)) for wp in wpl]
    out = local_map(
        dispatch, out_placements=list(part_f), in_placements=(tok, tok, tok, *wpl),
        in_grad_placements=(part_f, part_f, tok, *w_grads), device_mesh=mesh,
        redistribute_inputs=True)(x, top_w, top_i, *(lp[k] for k in names))
    return out, _aux(me, counts, n_tot, cfg)


def moe_ffn(x: torch.Tensor, lp: Tree, cfg: ModelConfig):
    """x [B,S,D] -> ([B,S,D], aux): top-k routing with a per-expert
    capacity; a token's output depends on the other tokens of its call
    through the assignments that overflow.  Sharded when a partitioner is
    ambient and x is a DTensor (``_moe_sharded``); else the JAX package's
    single-device branch."""
    part = current_partitioner()
    if part is not None and is_dtensor(x):
        return _moe_sharded(x, lp, cfg, part)
    top_w, top_i, aux = _router(x, lp, cfg)
    return _dispatch_compute(x, top_w, top_i, lp, cfg), aux


def moe_ffn_dense_fallback(x: torch.Tensor, lp: Tree, cfg: ModelConfig):
    """Dropless: x [B,S,D] -> ([B,S,D], aux).  Every token through all
    experts, weighted by a one-hot gate of its renormalised top-k weights:
    E/k times the routed work, and each token computed alone.  Rows are
    padded to ``ROW_BLOCK`` for every product."""
    b, s, d = x.shape
    t = b * s
    top_w, top_i, aux = _router(x, lp, cfg)
    gate = torch.zeros((t, cfg.num_experts), dtype=torch.float32, device=x.device)
    gate.scatter_(1, top_i.reshape(t, cfg.top_k), top_w.reshape(t, cfg.top_k))
    xf = _pad_rows(x.reshape(t, d))
    y = _experts(xf, lp["we_gate"], lp["we_up"], lp["we_down"])     # [E,R,D]
    out = torch.bmm(_pad_rows(gate.to(x.dtype))[:, None, :],
                    y.transpose(0, 1))[:, 0]                      # [R,D]
    if cfg.num_shared_experts:
        out = out + _shared(xf, lp)
    return out[:t].reshape(b, s, d), aux

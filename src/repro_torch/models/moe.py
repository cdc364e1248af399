"""Mixture-of-Experts FFN: a float32 router, the capacity dispatch and the
dropless path, with the JAX package's names and arithmetic.

  moe_param_specs          the expert leaves of a layer stack
  moe_ffn                  top-k routing with a per-expert capacity: the
                           assignments past it are dropped (the JAX
                           package's single-device branch)
  moe_ffn_dense_fallback   dropless: every token through its top-k experts
                           under a one-hot gate over all experts; what the
                           serving engine runs

The JAX package shards ``moe_ffn`` over a mesh when a partitioner is
ambient (``shard_map`` over the data shards, each expert's d_ff over the
model axis).  The port has no partitioner (ROADMAP Queue 1, item 4), so it
carries the single-device branch only.

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

from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import ParamSpec

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


def _router(x: torch.Tensor, lp: Tree, cfg: ModelConfig):
    """x [B,S,D] -> (top_w [B,S,k] float32, top_i [B,S,k] int64, aux loss):
    float32 logits, softmax, the top k renormalised, and the load-balancing
    loss E * sum(me * ce).  The logits' product runs on rows padded to
    ``ROW_BLOCK``."""
    b, s, d = x.shape
    t, e = b * s, cfg.num_experts
    rows = _pad_rows(x.reshape(t, d).float())
    logits = (rows @ lp["router"])[:t].reshape(b, s, e)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = _top_k(probs, cfg.top_k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=(0, 1))
    ce = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, top_i.reshape(-1), torch.ones(t * cfg.top_k, device=x.device)) / (
        t * cfg.top_k)
    return top_w, top_i, e * torch.sum(me * ce)


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
    their [E, cap, D] buffers, and each kept assignment's output, weighted,
    added into its token's row."""
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
    out = torch.zeros((t, d), dtype=x.dtype, device=dev).index_add_(
        0, src_tok, yflat[slot] * w_sorted[:, None])
    if cfg.num_shared_experts:
        out = out + _shared(xf, lp)
    return out.reshape(b, s, d)


def moe_ffn(x: torch.Tensor, lp: Tree, cfg: ModelConfig):
    """x [B,S,D] -> ([B,S,D], aux): top-k routing with a per-expert
    capacity; a token's output depends on the other tokens of its call
    through the assignments that overflow.  The JAX package's
    single-device branch (the port has no partitioner)."""
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

"""Decoder-only transformer, dense family (qwen3; any dense config without a
local/global pattern): prefill and decode steps for serving.

Weights keep the JAX tree's names and shapes (``abstract_params``); the
layer-stacked ``[L, ...]`` leaves reach this module as a list of per-layer
views (``repro_torch.convert.to_port_layout``), and the layers run in a
Python loop where the JAX package scans.

The decode cache is the JAX tree too: ``{"layers": (k, v)}`` with k and v of
shape ``[L, B, KV, S, hd]``, or ``(k, v, k_scale, v_scale)`` with int8
values and float32 scales ``[L, B, KV, S]`` when ``cache_dtype="int8"``.
Layer i reads the contiguous views ``[i]``.  Unlike the JAX functions, which
return a new cache, the port writes the cache in place: ``prefill`` fills a
zeroed cache of ``max_len`` positions (the decode layout, so nothing is
padded afterwards) and ``decode_step`` writes each row's new token at its
``cur_index`` into the cache it is given.

Attention runs through the hand-written kernels: the causal prefill through
flash attention, every decode step through flash-decode (float or int8
cache), with ``cur_index`` as an int or a [B] vector.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec, zeros

Tree = Dict[str, Any]

#: Prompts longer than this take the JAX package's blockwise branch; both
#: branches are the flash kernel here.
FULL_ATTENTION_MAX = 2048


def check_supported(cfg: ModelConfig) -> None:
    """The configurations this slice ports; the rest raise, naming the
    ROADMAP item that will port them."""
    if cfg.local_global_pattern != (0, 0) or cfg.sliding_window:
        raise NotImplementedError(
            f"{cfg.name}: local/global layers with ring caches are the gemma3 "
            f"slice (ROADMAP Queue 1, item 1)")
    if cfg.num_experts or cfg.first_dense_layers:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported (ROADMAP Queue 1, "
            f"remaining families)")
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not the dense transformer's "
            f"(models/registry.py routes each ported family; ROADMAP Queue 1 "
            f"lists the rest)")


# ---------------------------------------------------------------- param spec
def _attn_specs(cfg: ModelConfig, n: int, dtype: str) -> Tree:
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.resolved_kv_heads,
                    cfg.resolved_head_dim)
    p = {
        "attn_norm": ParamSpec((n, d), ("layers", "embed"), dtype, "zeros"),
        "wq": ParamSpec((n, d, h, hd), ("layers", "embed", "heads", "head_dim"), dtype),
        "wk": ParamSpec((n, d, kv, hd), ("layers", "embed", "kv_heads", "head_dim"), dtype),
        "wv": ParamSpec((n, d, kv, hd), ("layers", "embed", "kv_heads", "head_dim"), dtype),
        "wo": ParamSpec((n, h, hd, d), ("layers", "heads", "head_dim", "embed"), dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = ParamSpec((n, hd), ("layers", "head_dim"), dtype, "zeros")
        p["k_norm"] = ParamSpec((n, hd), ("layers", "head_dim"), dtype, "zeros")
    return p


def _mlp_specs(cfg: ModelConfig, n: int, dtype: str) -> Tree:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mlp_norm": ParamSpec((n, d), ("layers", "embed"), dtype, "zeros"),
        "w_gate": ParamSpec((n, d, f), ("layers", "embed", "mlp"), dtype),
        "w_up": ParamSpec((n, d, f), ("layers", "embed", "mlp"), dtype),
        "w_down": ParamSpec((n, f, d), ("layers", "mlp", "embed"), dtype),
    }


def abstract_params(cfg: ModelConfig) -> Tree:
    check_supported(cfg)
    dt = cfg.dtype
    v, d = cfg.vocab_padded, cfg.d_model
    p: Tree = {
        "embedding": ParamSpec((v, d), ("vocab", "embed"), dt, "small"),
        "final_norm": ParamSpec((d,), ("embed",), dt, "zeros"),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = ParamSpec((d, v), ("embed", "vocab"), dt, "small")
    p["layers"] = {**_attn_specs(cfg, cfg.num_layers, dt),
                   **_mlp_specs(cfg, cfg.num_layers, dt)}
    return p


def abstract_cache(cfg: ModelConfig, batch: int, seq_len: int) -> Tree:
    """ParamSpec tree of the decode cache; each leaf's logical names say
    where its batch axis is."""
    check_supported(cfg)
    kv, hd, n = cfg.resolved_kv_heads, cfg.resolved_head_dim, cfg.num_layers
    shape = (n, batch, kv, seq_len, hd)
    logical = ("layers", "batch", "cache_kv_heads", "cache_seq", None)
    dt = cfg.resolved_cache_dtype
    if dt == "int8":
        sshape, slog = shape[:-1], logical[:-1]
        return {"layers": (ParamSpec(shape, logical, "int8", "zeros"),
                           ParamSpec(shape, logical, "int8", "zeros"),
                           ParamSpec(sshape, slog, "float32", "zeros"),
                           ParamSpec(sshape, slog, "float32", "zeros"))}
    return {"layers": (ParamSpec(shape, logical, dt, "zeros"),
                       ParamSpec(shape, logical, dt, "zeros"))}


# --------------------------------------------------------------------- layer
def _sincos(cfg: ModelConfig, positions: torch.Tensor):
    rd = cfg.resolved_head_dim // 2 if cfg.rope_2d else cfg.resolved_head_dim
    return L.rope_freqs(positions, cfg.resolved_head_dim, cfg.rope_theta, rd)


def _write_prompt(cache: Tuple[torch.Tensor, ...], k: torch.Tensor,
                  v: torch.Tensor) -> None:
    """Prefill: positions 0..S-1 of one layer's cache from k, v [B,S,KV,hd]."""
    s = k.shape[1]
    kc, vc = k.transpose(1, 2), v.transpose(1, 2)   # [B,KV,S,hd]
    if len(cache) == 4:
        for dst, sdst, src in ((cache[0], cache[2], kc), (cache[1], cache[3], vc)):
            qv, sc = L.quantize_token_kv(src)
            dst[:, :, :s] = qv
            sdst[:, :, :s] = sc
    else:
        cache[0][:, :, :s] = kc
        cache[1][:, :, :s] = vc


def _write_token(cache: Tuple[torch.Tensor, ...], k1: torch.Tensor,
                 v1: torch.Tensor, cur_index) -> None:
    """Decode: the new token k1, v1 [B,KV,hd] of each row at its position.
    A [B] index writes row b at column cur_index[b] (clamped to the last
    column: a row past the end of its cache is finished and its writes are
    never read), an int writes every row at that column."""
    if isinstance(cur_index, torch.Tensor):
        rows = torch.arange(k1.shape[0], device=k1.device)
        col = cur_index.to(device=k1.device, dtype=torch.long).clamp(
            max=cache[0].shape[2] - 1)
        idx = (rows, slice(None), col)
    else:
        idx = (slice(None), slice(None), cur_index)
    if len(cache) == 4:
        for dst, sdst, src in ((cache[0], cache[2], k1), (cache[1], cache[3], v1)):
            qv, sc = L.quantize_token_kv(src[:, :, None])
            dst[idx] = qv[:, :, 0]
            sdst[idx] = sc[:, :, 0]
    else:
        cache[0][idx] = k1.to(cache[0].dtype)
        cache[1][idx] = v1.to(cache[1].dtype)


def _attention(x, lp, cfg: ModelConfig, sincos, cache, cur_index):
    """One attention sub-block; ``cur_index`` None is the prefill.  Writes
    the layer's cache in place and returns the residual delta."""
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = L.project_heads(h, lp["wq"])
    k = L.project_heads(h, lp["wk"])
    v = L.project_heads(h, lp["wv"])
    if cfg.qk_norm:
        q = L.rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, lp["k_norm"], cfg.norm_eps)
    sin, cos = sincos
    rd = cfg.resolved_head_dim // 2 if cfg.rope_2d else cfg.resolved_head_dim
    q = L.apply_rope(q, sin, cos, rd)
    k = L.apply_rope(k, sin, cos, rd)
    if cur_index is None:
        if x.shape[1] > FULL_ATTENTION_MAX:
            att = L.attention_blockwise(q, k, v, causal=True)
        else:
            att = L.attention_full(q, k, v, causal=True)
        _write_prompt(cache, k, v)
    else:
        k1, v1 = k[:, 0], v[:, 0]
        _write_token(cache, k1, v1, cur_index)
        if len(cache) == 4:
            att = L.attention_decode_int8(q[:, 0], *cache, cur_index)[:, None]
        else:
            att = L.attention_decode(q[:, 0], cache[0], cache[1],
                                     cur_index)[:, None]
    return L.merge_heads(att, lp["wo"])


def _stack(params: Tree, x: torch.Tensor, cfg: ModelConfig, cache: Tree,
           positions: torch.Tensor, cur_index) -> torch.Tensor:
    sincos = _sincos(cfg, positions)
    leaves = cache["layers"]
    for i, lp in enumerate(params["layers"]):
        x = x + _attention(x, lp, cfg, sincos, tuple(c[i] for c in leaves),
                           cur_index)
        h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + L.swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def _unembed(params: Tree, cfg: ModelConfig) -> torch.Tensor:
    return params["embedding"].T if cfg.tie_embeddings else params["unembed"]


# ----------------------------------------------------------------- public API
def prefill(params: Tree, tokens: torch.Tensor, cfg: ModelConfig, *,
            max_len: Optional[int] = None):
    """tokens [B,S] -> (last-token logits [B,V] float32, cache).  The cache
    has ``max_len`` positions (default S), zeros past the prompt: the JAX
    engine's padded decode layout, written directly."""
    b, s = tokens.shape
    max_len = s if max_len is None else max_len
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    cache = zeros(abstract_cache(cfg, b, max_len), tokens.device)
    x = params["embedding"][tokens]
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    x = _stack(params, x, cfg, cache, positions, None)
    return (x[:, -1] @ _unembed(params, cfg)).float(), cache


def decode_step(params: Tree, cache: Tree, tokens: torch.Tensor, cur_index,
                cfg: ModelConfig) -> torch.Tensor:
    """tokens [B] at positions ``cur_index`` (an int, or a [B] tensor on the
    tokens' device) -> logits [B,V] float32; the cache is written in place."""
    b = tokens.shape[0]
    if isinstance(cur_index, torch.Tensor):
        positions = cur_index.to(tokens.device)[:, None]
    else:
        if not 0 <= cur_index < cache["layers"][0].shape[3]:
            raise ValueError(f"cur_index {cur_index} outside the cache")
        positions = torch.full((b, 1), cur_index, device=tokens.device)
    x = params["embedding"][tokens[:, None]]
    x = _stack(params, x, cfg, cache, positions, cur_index)
    return (x[:, 0] @ _unembed(params, cfg)).float()

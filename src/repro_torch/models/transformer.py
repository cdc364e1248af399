"""Decoder-only transformer covering the dense, moe and vlm families: the
uniform stack (qwen3, chatglm3's half-dim rotary, deepseek-67b), gemma3's
local/global period layout, MoE layers (``models/moe.py``) after leading
dense layers (deepseek-moe's layer 0, the ``dense0`` leaves), and a VLM's
patch embeddings pasted over the first positions (internvl2), with prefill
and decode steps for serving.

Weights keep the JAX tree's names and shapes (``abstract_params``); the
layer-stacked ``[L, ...]`` leaves reach this module as a list of per-layer
views (``repro_torch.convert.to_port_layout``), and the layers run in a
Python loop where the JAX package scans.

The decode cache is the JAX tree too.  A uniform stack keeps
``{"layers": (k, v)}`` with k and v of shape ``[L, B, KV, S, hd]``, or
``(k, v, k_scale, v_scale)`` with int8 values and float32 scales
``[L, B, KV, S]`` when ``cache_dtype="int8"``; leading dense layers keep
theirs under ``"dense0"``, and ``"layers"`` holds the rest.  A
local/global pattern (gemma3: periods of 5 local layers and 1 global one,
then local tail layers) keeps ``{"local": [P, 5, B, KV, w, hd], "global": [P, B, KV, S,
hd], "tail": [T, B, KV, w, hd]}`` pairs, where a local layer's ring holds
``w = min(window, S)`` slots and position t lives in slot ``t % window``.
Layer i reads the contiguous views of its leaf (``layer_slots``).  Unlike
the JAX functions, which return a new cache, the port writes the cache in
place: ``prefill`` fills a zeroed cache of ``max_len`` positions (the decode
layout, so nothing is padded afterwards; a ring gets the prompt's last
``min(w, S)`` positions at their slots, which is the JAX package's roll
followed by its engine's zero pad) and ``decode_step`` writes each row's new
token at its ``cur_index`` (a ring: at ``cur_index % window``) into the
cache it is given.

Attention runs through the hand-written kernels: the causal prefill of a
global (or uniform) layer through flash attention, every decode step
through flash-decode (float or int8 cache), with ``cur_index`` as an int or
a [B] vector.  A local layer's prefill is plain PyTorch (``layers.py``);
its decode is flash-decode over the ring at ``min(cur_index, w - 1)``: a
ring whose slots have all been written is valid everywhere, and before the
first wrap its valid slots are the prefix 0..cur, so that index computes
``layers.attention_decode_ring``.

A MoE layer's FFN is ``moe.moe_ffn`` (the capacity dispatch) or, with
``dropless=True`` as the serving engine runs it, ``moe.moe_ffn_dense_fallback``.

Under a partitioner (``models/param.py``) the weights, the cache and the
inputs are DTensors: activations are held to the JAX package's layouts by
``constrain`` at its call sites, the kernels run on each rank's shards
(``repro_torch.sharding.local``), and each rank writes the cache positions
it holds.

``loss_fn`` is the training path: a full causal forward with no cache, each
layer under ``torch.utils.checkpoint`` (the JAX package's ``remat=True``),
the MoE layers' load-balancing losses summed beside it, and the chunked
cross entropy.  Its attention is the flash kernel's forward (run again in
the backward's recompute) with the backward kernel as its gradient; a local
layer's stays plain windowed attention, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import moe_ffn, moe_ffn_dense_fallback, moe_param_specs
from repro_torch.models.param import ParamSpec, constrain, zeros
from repro_torch.sharding import local as shard_local

Tree = Dict[str, Any]

#: Prompts longer than this take the JAX package's blockwise branch; without
#: a window both branches are the flash kernel here.
FULL_ATTENTION_MAX = 2048


#: families this module carries; models/registry.py routes the others
#: (ssm: rwkv6.py, audio: encdec.py, hybrid: mamba2.py)
FAMILIES = ("dense", "moe", "vlm")


def check_supported(cfg: ModelConfig) -> None:
    """The configurations this module carries; the rest raise."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not the transformer's "
            f"{FAMILIES}; models/registry.py routes it to its own module")
    loc, glob = cfg.local_global_pattern
    if (loc or glob) and (glob != 1 or not cfg.sliding_window):
        raise NotImplementedError(
            f"{cfg.name}: a local/global pattern {cfg.local_global_pattern} "
            f"with window {cfg.sliding_window}: the JAX package's period "
            f"layout (and so the port's) holds one global layer per period "
            f"and a window > 0 (configs/base.py, local_global_pattern)")


# ------------------------------------------------------------------ pattern
def layer_pattern(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_periods, period, tail): gemma3-27b (10, 6, 2); uniform (0, 0, L)."""
    loc, glob = cfg.local_global_pattern
    if not (loc or glob):
        return 0, 0, cfg.num_layers
    period = loc + glob
    return cfg.num_layers // period, period, cfg.num_layers % period


def _is_local(cfg: ModelConfig, idx_in_period: int) -> bool:
    return idx_in_period < cfg.local_global_pattern[0]


def layer_slots(cfg: ModelConfig) -> List[Tuple[str, Tuple[int, ...], int]]:
    """Per layer: (cache leaf, index into its leading axes, attention
    window; 0 = full).  A uniform stack's leading dense layers first
    (``dense0``); the JAX package's period scan in a flat list: a period's
    local layers, then its global one; the tail layers are local."""
    n_periods, period, tail = layer_pattern(cfg)
    if not period:
        fd = cfg.first_dense_layers
        return ([("dense0", (i,), 0) for i in range(fd)]
                + [("layers", (i,), 0) for i in range(cfg.num_layers - fd)])
    w = cfg.sliding_window
    out = [("local", (p, j), w) if _is_local(cfg, j) else ("global", (p,), 0)
           for p in range(n_periods) for j in range(period)]
    return out + [("tail", (i,), w) for i in range(tail)]


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


def _layer_specs(cfg: ModelConfig, n: int, dtype: str, moe: bool) -> Tree:
    return {**_attn_specs(cfg, n, dtype),
            **(moe_param_specs(cfg, n, dtype) if moe else _mlp_specs(cfg, n, dtype))}


def dataclass_ff(cfg: ModelConfig) -> ModelConfig:
    """cfg with d_ff swapped for the leading dense layers' width."""
    return dataclasses.replace(cfg, d_ff=cfg.dense_ff or cfg.d_ff)


def abstract_params(cfg: ModelConfig) -> Tree:
    check_supported(cfg)
    dt = cfg.dtype
    v, d = cfg.vocab_padded, cfg.d_model
    is_moe = cfg.num_experts > 0
    p: Tree = {
        "embedding": ParamSpec((v, d), ("vocab", "embed"), dt, "small"),
        "final_norm": ParamSpec((d,), ("embed",), dt, "zeros"),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = ParamSpec((d, v), ("embed", "vocab"), dt, "small")
    if cfg.first_dense_layers:  # leading dense layers (deepseek-moe)
        p["dense0"] = _layer_specs(dataclass_ff(cfg), cfg.first_dense_layers, dt,
                                   moe=False)
    n = cfg.num_layers - cfg.first_dense_layers if is_moe else cfg.num_layers
    p["layers"] = _layer_specs(cfg, n, dt, moe=is_moe)
    return p


def abstract_cache(cfg: ModelConfig, batch: int, seq_len: int) -> Tree:
    """ParamSpec tree of the decode cache; each leaf's logical names say
    where its batch axis is."""
    check_supported(cfg)
    kv, hd = cfg.resolved_kv_heads, cfg.resolved_head_dim
    dt = cfg.resolved_cache_dtype

    def kvspec(lead: Tuple[int, ...], s: int):
        shape = lead + (batch, kv, s, hd)
        logical = ("layers",) * len(lead) + ("batch", "cache_kv_heads",
                                             "cache_seq", None)
        if dt == "int8":
            sshape, slog = shape[:-1], logical[:-1]
            return (ParamSpec(shape, logical, "int8", "zeros"),
                    ParamSpec(shape, logical, "int8", "zeros"),
                    ParamSpec(sshape, slog, "float32", "zeros"),
                    ParamSpec(sshape, slog, "float32", "zeros"))
        return (ParamSpec(shape, logical, dt, "zeros"),
                ParamSpec(shape, logical, dt, "zeros"))

    n_periods, period, tail = layer_pattern(cfg)
    c: Tree = {}
    if cfg.first_dense_layers:
        c["dense0"] = kvspec((cfg.first_dense_layers,), seq_len)
    if not period:
        c["layers"] = kvspec((cfg.num_layers - cfg.first_dense_layers,), seq_len)
        return c
    w = min(cfg.sliding_window, seq_len)
    if n_periods:
        c["local"] = kvspec((n_periods, cfg.local_global_pattern[0]), w)
        c["global"] = kvspec((n_periods,), seq_len)
    if tail:
        c["tail"] = kvspec((tail,), w)
    return c


# --------------------------------------------------------------------- layer
def _sincos(cfg: ModelConfig, positions: torch.Tensor):
    rd = cfg.resolved_head_dim // 2 if cfg.rope_2d else cfg.resolved_head_dim
    return L.rope_freqs(positions, cfg.resolved_head_dim, cfg.rope_theta, rd)


def _write_prompt(cache: Tuple[torch.Tensor, ...], k: torch.Tensor,
                  v: torch.Tensor, window: int) -> None:
    """Prefill: one layer's cache from k, v [B,S,KV,hd]: positions 0..S-1,
    or for a ring of w slots (``window`` > 0) the prompt's last min(w, S)
    positions, position t at slot t % window."""
    s = k.shape[1]
    kc, vc = k.transpose(1, 2), v.transpose(1, 2)   # [B,KV,S,hd]
    if window:
        keep = min(cache[0].shape[2], s)
        kc, vc = (torch.roll(x[:, :, s - keep:], s % keep, dims=2) for x in (kc, vc))
        s = keep
    if len(cache) == 4:
        (kq, ks), (vq, vs) = L.quantize_token_kv(kc), L.quantize_token_kv(vc)
        srcs = (kq, vq, ks, vs)
    else:
        srcs = (kc, vc)
    if shard_local.sharded(cache[0]):
        shard_local.write_prompt(cache, srcs)
        return
    for dst, src in zip(cache, srcs):
        dst[:, :, :s] = src


def _write_token(cache: Tuple[torch.Tensor, ...], k1: torch.Tensor,
                 v1: torch.Tensor, cur_index) -> None:
    """Decode: the new token k1, v1 [B,KV,hd] of each row at its position.
    A [B] index writes row b at column cur_index[b] (clamped to the last
    column: a row past the end of its cache is finished and its writes are
    never read), an int writes every row at that column."""
    if len(cache) == 4:
        (kq, ks), (vq, vs) = (L.quantize_token_kv(x[:, :, None]) for x in (k1, v1))
        srcs = (kq, vq, ks, vs)
    else:
        srcs = (k1[:, :, None], v1[:, :, None])
    if shard_local.sharded(cache[0]):
        shard_local.write_token(cache, srcs, cur_index)
        return
    if isinstance(cur_index, torch.Tensor):
        rows = torch.arange(k1.shape[0], device=k1.device)
        col = cur_index.to(device=k1.device, dtype=torch.long).clamp(
            max=cache[0].shape[2] - 1)
        idx = (rows, slice(None), col)
    else:
        idx = (slice(None), slice(None), cur_index)
    for dst, src in zip(cache, srcs):
        dst[idx] = src[:, :, 0].to(dst.dtype)


def _gathered(w: torch.Tensor, cfg: ModelConfig, *logical) -> torch.Tensor:
    """ZeRO-3 weight gather: with ``fsdp_weight_gather``, an FSDP-sharded
    weight redistributed so that its contraction dim is whole before the
    product, instead of reducing the (much larger) activations after it."""
    if not cfg.fsdp_weight_gather:
        return w
    return constrain(w, *logical)


def _attention(x, lp, cfg: ModelConfig, sincos, cache, cur_index, window):
    """One attention sub-block; ``cur_index`` None is the prefill, or with
    ``cache`` None too the training forward, which writes no cache; a
    ``window`` > 0 makes it a local layer over a ring cache.  Writes the
    layer's cache in place and returns the residual delta."""
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = L.project_heads(h, _gathered(lp["wq"], cfg, None, "heads", None))
    k = L.project_heads(h, _gathered(lp["wk"], cfg, None, "kv_heads", None))
    v = L.project_heads(h, _gathered(lp["wv"], cfg, None, "kv_heads", None))
    if cfg.qk_norm:
        q = L.rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, lp["k_norm"], cfg.norm_eps)
    sin, cos = sincos
    rd = cfg.resolved_head_dim // 2 if cfg.rope_2d else cfg.resolved_head_dim
    q = L.apply_rope(q, sin, cos, rd)
    k = L.apply_rope(k, sin, cos, rd)
    q = constrain(q, "batch", "seq", "act_heads", None)
    if cur_index is None:
        if x.shape[1] > FULL_ATTENTION_MAX:
            att = L.attention_blockwise(q, k, v, causal=True, window=window)
        else:
            att = L.attention_full(q, k, v, causal=True, window=window)
        if cache is not None:
            _write_prompt(cache, k, v, window)
    else:
        k1, v1 = k[:, 0], v[:, 0]
        if window:
            # a ring: write at cur % window; attend over the written prefix
            _write_token(cache, k1, v1, cur_index % window)
            last = cache[0].shape[2] - 1
            seen = (cur_index.clamp(max=last) if isinstance(cur_index, torch.Tensor)
                    else min(cur_index, last))
        else:
            _write_token(cache, k1, v1, cur_index)
            seen = cur_index
        if len(cache) == 4:
            att = L.attention_decode_int8(q[:, 0], *cache, seen)[:, None]
        else:
            att = L.attention_decode(q[:, 0], cache[0], cache[1], seen)[:, None]
    att = constrain(att, "batch", "seq", "act_heads", None)
    return L.merge_heads(att, _gathered(lp["wo"], cfg, "heads", None, None))


def _ffn(x, lp, cfg: ModelConfig, moe: bool, dropless: bool):
    """-> (residual delta, the MoE layer's aux loss; 0.0 for a dense one)."""
    if not moe:
        h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        return L.swiglu(h, _gathered(lp["w_gate"], cfg, None, "mlp"),
                        _gathered(lp["w_up"], cfg, None, "mlp"),
                        _gathered(lp["w_down"], cfg, "mlp", None)), 0.0
    h = L.rms_norm(x, lp["moe_norm"], cfg.norm_eps)
    return (moe_ffn_dense_fallback if dropless else moe_ffn)(h, lp, cfg)


def _layer(x, lp, cfg: ModelConfig, sincos, cache, cur_index, window, moe, dropless):
    x = x + _attention(x, lp, cfg, sincos, cache, cur_index, window)
    ff, aux = _ffn(x, lp, cfg, moe, dropless)
    return constrain(x + ff, "batch", "seq_res", "act_embed"), aux


def _stack(params: Tree, x: torch.Tensor, cfg: ModelConfig, cache: Optional[Tree],
           positions: torch.Tensor, cur_index, dropless: bool):
    """Every layer, then the final norm -> (x, aux).  ``cache`` None is the
    training forward: each layer under ``torch.utils.checkpoint``, so that
    only its input is kept and its activations are recomputed in the
    backward, and aux sums the MoE layers' load-balancing losses (0.0 when
    there are none, and when serving)."""
    sincos = _sincos(cfg, positions)
    moe = cfg.num_experts > 0
    lps = ([(lp, False) for lp in params.get("dense0", [])]
           + [(lp, moe) for lp in params["layers"]])
    aux = 0.0
    for (lp, is_moe), (leaf, idx, window) in zip(lps, layer_slots(cfg)):
        if cache is None:
            x, a = checkpoint(_layer, x, lp, cfg, sincos, None, None, window, is_moe,
                              dropless, use_reentrant=False)
            aux = aux + a
        else:
            x, _ = _layer(x, lp, cfg, sincos, tuple(c[idx] for c in cache[leaf]),
                          cur_index, window, is_moe, dropless)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def _embed(params: Tree, tokens: torch.Tensor, cfg: ModelConfig,
           patch_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings; with ``embed_scale`` (gemma) scaled by
    sqrt(d_model), the root taken in the embeddings' type as the JAX package
    takes it (bfloat16 rounds sqrt(5376) = 73.32 to 73.5).  A VLM's
    ``patch_embeds`` [B, P, d_model] (P <= S) replace the first P
    positions."""
    x = L.embed(params["embedding"], tokens)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model, dtype=x.dtype, device=x.device) ** 0.5
    if patch_embeds is not None:
        b, s, d = x.shape
        if cfg.family != "vlm":
            raise ValueError(f"{cfg.name}: patch embeddings need the vlm family, "
                             f"not {cfg.family!r}")
        if (patch_embeds.dim() != 3 or patch_embeds.shape[0] != b
                or patch_embeds.shape[1] > s or patch_embeds.shape[2] != d):
            raise ValueError(f"patch_embeds {tuple(patch_embeds.shape)} do not fit "
                             f"the embeddings [{b}, {s}, {d}]")
        x[:, :patch_embeds.shape[1]] = patch_embeds.to(x.dtype)
    return constrain(x, "batch", "seq_res", "act_embed")


def _unembed(params: Tree, cfg: ModelConfig) -> torch.Tensor:
    return params["embedding"].T if cfg.tie_embeddings else params["unembed"]


# ----------------------------------------------------------------- public API
def prefill(params: Tree, tokens: torch.Tensor, cfg: ModelConfig, *,
            max_len: Optional[int] = None, dropless: bool = False,
            patch_embeds: Optional[torch.Tensor] = None):
    """tokens [B,S] -> (last-token logits [B,V] float32, cache).  The cache
    has ``max_len`` positions (default S), zeros past the prompt: the JAX
    engine's padded decode layout, written directly.  ``dropless`` routes
    MoE layers through ``moe_ffn_dense_fallback``; a VLM's ``patch_embeds``
    [B, min(frontend_tokens, S), d_model] replace the first positions'
    embeddings."""
    b, s = tokens.shape
    max_len = s if max_len is None else max_len
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    cache = zeros(abstract_cache(cfg, b, max_len), tokens.device, params["embedding"])
    x = _embed(params, tokens, cfg, patch_embeds)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    x, _ = _stack(params, x, cfg, cache, positions, None, dropless)
    return (x[:, -1] @ _unembed(params, cfg)).float(), cache


def decode_step(params: Tree, cache: Tree, tokens: torch.Tensor, cur_index,
                cfg: ModelConfig, *, dropless: bool = False) -> torch.Tensor:
    """tokens [B] at positions ``cur_index`` (an int, or a [B] tensor on the
    tokens' device) -> logits [B,V] float32; the cache is written in place.
    A decode step injects no patch embeddings, as in the JAX package."""
    b = tokens.shape[0]
    if isinstance(cur_index, torch.Tensor):
        positions = cur_index.to(tokens.device)[:, None]
    else:
        full = [cache[k][0].shape[-2] for k in ("layers", "global") if k in cache]
        if cur_index < 0 or (full and cur_index >= full[0]):
            raise ValueError(f"cur_index {cur_index} outside the cache")
        positions = torch.full((b, 1), cur_index, device=tokens.device)
    x = _embed(params, tokens[:, None], cfg)
    x, _ = _stack(params, x, cfg, cache, positions, cur_index, dropless)
    return (x[:, 0] @ _unembed(params, cfg)).float()


def loss_fn(params: Tree, batch: Tree, cfg: ModelConfig, *, dropless: bool = False):
    """batch: tokens [B,S], labels [B,S] (and a VLM's ``patch_embeds``) ->
    (ce + 0.01 aux, {"ce", "aux"}): the mean next-token cross entropy and
    the MoE layers' summed load-balancing loss (0 for a dense stack)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed(params, tokens, cfg,
               batch.get("patch_embeds") if cfg.family == "vlm" else None)
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    x, aux = _stack(params, x, cfg, None, positions, None, dropless)
    ce = L.chunked_cross_entropy(x, _unembed(params, cfg), batch["labels"])
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}

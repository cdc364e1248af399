"""Whisper-style encoder-decoder (arXiv:2212.04356), the audio family:
prefill and decode steps for serving.

The mel-spectrogram and conv frontend is a stub, as in the JAX package:
the encoder takes precomputed frame embeddings [B, frontend_tokens, D].
Both sides add sinusoidal positions (the JAX package's deviation from
whisper's learned decoder positions, which keeps decode length-agnostic).
The MLP is GELU in its tanh form, ``jax.nn.gelu``'s default.

Weights keep the JAX tree's names and shapes (``abstract_params``); the
layer-stacked leaves under ``encoder`` and ``decoder`` reach this module as
lists of per-layer views (``repro_torch.convert.to_port_layout``).

The decode cache is the JAX tree: ``{"decoder": (self_k, self_v, cross_k,
cross_v)}``, each ``[L, B, KV, S, hd]``, with S the self cache's length and
``frontend_tokens`` for the cross K/V.  Unlike the JAX functions, which
return a new cache, ``prefill`` fills a zeroed cache of ``max_len``
positions (the engine's padded decode layout) and ``decode_step`` writes
the new token's self K/V at ``cur_index`` into the cache it is given; the
cross K/V, computed once from the encoder output, are read and never
written.

Attention runs through the hand-written kernels: the encoder's
self-attention and the decoder's cross-attention (Sq != Sk) through the
non-causal flash kernel, the decoder's causal self-attention through the
causal one, and every decode read (the self cache at ``cur_index``, the
cross cache at ``frontend_tokens - 1``) through flash-decode.  Decode takes
one scalar ``cur_index`` for the whole batch, as the JAX package's does;
the cache is built per request, so slot serving is refused by the engine
and a batch is served by ``generate``.  For a row of that batch to come out
as it would alone, every product runs at a shape that does not depend on
the batch (``layers.per_row_matmul``: a prefill row by row, a decode step
on blocks of 16 rows), since cuBLAS sums a row in an order it picks by the
product's shape; the kernels and norms already treat each row apart.

``loss_fn`` is the training path: the encoder over the stub frames and the
decoder with no cache, each layer under ``torch.utils.checkpoint``, then the
chunked cross entropy through the embedding's transpose; every attention
differentiates through the flash backward kernel on the card.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec, constrain, zeros
from repro_torch.models.transformer import FULL_ATTENTION_MAX, _write_prompt, _write_token

Tree = Dict[str, Any]


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """[..., d] float32: sines then cosines over d/2 frequencies, the
    spacing log(10000) / (d/2 - 1), as the JAX package spaces them."""
    half = d // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=positions.device)
                      * (math.log(10000.0) / (half - 1)))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _attn_specs(cfg: ModelConfig, n: int, dtype: str, prefix: str = "") -> Tree:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.resolved_kv_heads, cfg.resolved_head_dim
    return {
        prefix + "norm": ParamSpec((n, d), ("layers", "embed"), dtype, "zeros"),
        prefix + "wq": ParamSpec((n, d, h, hd), ("layers", "embed", "heads", "head_dim"), dtype),
        prefix + "wk": ParamSpec((n, d, kv, hd), ("layers", "embed", "kv_heads", "head_dim"), dtype),
        prefix + "wv": ParamSpec((n, d, kv, hd), ("layers", "embed", "kv_heads", "head_dim"), dtype),
        prefix + "wo": ParamSpec((n, h, hd, d), ("layers", "heads", "head_dim", "embed"), dtype),
    }


def _mlp_specs(cfg: ModelConfig, n: int, dtype: str) -> Tree:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mlp_norm": ParamSpec((n, d), ("layers", "embed"), dtype, "zeros"),
        "w1": ParamSpec((n, d, f), ("layers", "embed", "mlp"), dtype),
        "w2": ParamSpec((n, f, d), ("layers", "mlp", "embed"), dtype),
    }


def abstract_params(cfg: ModelConfig) -> Tree:
    dt = cfg.dtype
    enc = _attn_specs(cfg, cfg.encoder_layers, dt)
    enc.update(_mlp_specs(cfg, cfg.encoder_layers, dt))
    dec = _attn_specs(cfg, cfg.num_layers, dt)
    dec.update(_attn_specs(cfg, cfg.num_layers, dt, prefix="x_"))
    dec.update(_mlp_specs(cfg, cfg.num_layers, dt))
    return {
        "embedding": ParamSpec((cfg.vocab_padded, cfg.d_model), ("vocab", "embed"), dt, "small"),
        "enc_final_norm": ParamSpec((cfg.d_model,), ("embed",), dt, "zeros"),
        "final_norm": ParamSpec((cfg.d_model,), ("embed",), dt, "zeros"),
        "encoder": enc,
        "decoder": dec,
    }


def abstract_cache(cfg: ModelConfig, batch: int, seq_len: int) -> Tree:
    kv, hd, nl = cfg.resolved_kv_heads, cfg.resolved_head_dim, cfg.num_layers
    dt = cfg.resolved_cache_dtype
    self_shape = (nl, batch, kv, seq_len, hd)
    cross_shape = (nl, batch, kv, cfg.frontend_tokens, hd)
    log = ("layers", "batch", "cache_kv_heads", "cache_seq", None)
    logx = ("layers", "batch", "cache_kv_heads", None, None)
    return {
        "decoder": (
            ParamSpec(self_shape, log, dt, "zeros"),
            ParamSpec(self_shape, log, dt, "zeros"),
            ParamSpec(cross_shape, logx, dt, "zeros"),
            ParamSpec(cross_shape, logx, dt, "zeros"),
        )
    }


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B,S,D] @ w [D,H,hd] -> contiguous [B,S,H,hd]."""
    b, s, _ = x.shape
    return L.per_row_matmul(x, w.reshape(w.shape[0], -1)).view(b, s, w.shape[1], w.shape[2])


def _merge(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B,S,H,hd] @ w [H,hd,D] -> [B,S,D]."""
    b, s = x.shape[:2]
    return L.per_row_matmul(x.reshape(b, s, -1), w.reshape(-1, w.shape[-1]))


def _mlp(x: torch.Tensor, lp: Tree, cfg: ModelConfig) -> torch.Tensor:
    h = L.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    h = F.gelu(L.per_row_matmul(h, lp["w1"]), approximate="tanh")
    h = constrain(h, "batch", "seq", "act_mlp")
    return L.per_row_matmul(h, lp["w2"])


def _encoder_layer(x: torch.Tensor, lp: Tree, cfg: ModelConfig) -> torch.Tensor:
    h = L.rms_norm(x, lp["norm"], cfg.norm_eps)
    q, k, v = (_project(h, lp[w]) for w in ("wq", "wk", "wv"))
    x = x + _merge(L.attention_full(q, k, v, causal=False), lp["wo"])
    return constrain(x + _mlp(x, lp, cfg), "batch", "seq_res", "act_embed")


def encode(params: Tree, frames: torch.Tensor, cfg: ModelConfig, *,
           remat: bool = False) -> torch.Tensor:
    """frames [B, F, D] stub embeddings -> encoder output [B, F, D];
    ``remat`` runs each layer under ``torch.utils.checkpoint`` (training)."""
    _, f, d = frames.shape
    pos = torch.arange(f, device=frames.device)
    x = frames + _sinusoid(pos, d)[None].to(frames.dtype)
    x = constrain(x, "batch", "seq_res", "act_embed")
    for lp in params["encoder"]:
        x = (checkpoint(_encoder_layer, x, lp, cfg, use_reentrant=False) if remat
             else _encoder_layer(x, lp, cfg))
    return L.rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def _embed_tokens(params: Tree, tokens: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor) -> torch.Tensor:
    x = L.embed(params["embedding"], tokens)
    x = x + _sinusoid(positions, cfg.d_model).to(x.dtype)
    return constrain(x, "batch", "seq_res", "act_embed")


def _cross_kv(enc: torch.Tensor, lp: Tree):
    """One layer's cross K/V [B, F, KV, hd] from the encoder output."""
    return _project(enc, lp["x_wk"]), _project(enc, lp["x_wv"])


def _decoder_layer(x: torch.Tensor, lp: Tree, cfg: ModelConfig,
                   enc: Optional[torch.Tensor], cache, cur_index: Optional[int]):
    """One decoder layer; ``cache`` is its (self k, self v, cross k, cross v)
    views, or None in training, which writes nothing."""
    h = L.rms_norm(x, lp["norm"], cfg.norm_eps)
    q, k, v = (_project(h, lp[w]) for w in ("wq", "wk", "wv"))
    if cur_index is None:
        if x.shape[1] > FULL_ATTENTION_MAX:
            att = L.attention_blockwise(q, k, v, causal=True)
        else:
            att = L.attention_full(q, k, v, causal=True)
        if cache is not None:
            _write_prompt(cache[:2], k, v, 0)
    else:
        _write_token(cache[:2], k[:, 0], v[:, 0], cur_index)
        att = L.attention_decode(q[:, 0], cache[0], cache[1], cur_index)[:, None]
    x = x + _merge(att, lp["wo"])

    h = L.rms_norm(x, lp["x_norm"], cfg.norm_eps)
    qx = _project(h, lp["x_wq"])
    if cur_index is None:
        kx, vx = _cross_kv(enc, lp)
        attx = L.attention_full(qx, kx, vx, causal=False)
        if cache is not None:
            cache[2].copy_(kx.transpose(1, 2))
            cache[3].copy_(vx.transpose(1, 2))
    else:
        attx = L.attention_decode(qx[:, 0], cache[2], cache[3],
                                  cache[2].shape[2] - 1)[:, None]
    x = x + _merge(attx, lp["x_wo"])
    return constrain(x + _mlp(x, lp, cfg), "batch", "seq_res", "act_embed")


def _decoder_stack(params: Tree, x: torch.Tensor, enc: Optional[torch.Tensor],
                   cfg: ModelConfig, cache: Optional[Tree],
                   cur_index: Optional[int]) -> torch.Tensor:
    """x [B, S, D] with positions added.  ``cur_index`` None is the prefill
    (``enc`` the encoder output; the self and cross caches are written),
    an int a decode step (``enc`` unused; the cross cache is read at
    ``frontend_tokens - 1``); ``cache`` None is the training forward, each
    layer under ``torch.utils.checkpoint``."""
    for i, lp in enumerate(params["decoder"]):
        if cache is None:
            x = checkpoint(_decoder_layer, x, lp, cfg, enc, None, None,
                           use_reentrant=False)
        else:
            x = _decoder_layer(x, lp, cfg, enc, tuple(c[i] for c in cache["decoder"]),
                               cur_index)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def _logits(params: Tree, x: torch.Tensor) -> torch.Tensor:
    """x [B,D] -> float32 logits [B,V] through the embedding's transpose."""
    return L.row_blocks_matmul(x, params["embedding"].T).float()


# ----------------------------------------------------------------- public API
def prefill(params: Tree, tokens: torch.Tensor, cfg: ModelConfig, *,
            frames: torch.Tensor, max_len: Optional[int] = None,
            patch_embeds=None, **_):
    """tokens [B,S] over frames [B, F, D] -> (last-token logits [B,V]
    float32, cache of ``max_len`` self positions, default S).  ``dropless``
    is accepted and ignored; patch embeddings belong to the vlm family."""
    if patch_embeds is not None:
        raise ValueError(f"{cfg.name}: patch embeddings need the vlm family, "
                         f"not {cfg.family!r}")
    b, s = tokens.shape
    max_len = s if max_len is None else max_len
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    if tuple(frames.shape) != (b, cfg.frontend_tokens, cfg.d_model):
        raise ValueError(f"frames {tuple(frames.shape)} are not [B, frontend_tokens, "
                         f"d_model] = {(b, cfg.frontend_tokens, cfg.d_model)}")
    enc = encode(params, frames.to(device=tokens.device, dtype=getattr(torch, cfg.dtype)),
                 cfg)
    cache = zeros(abstract_cache(cfg, b, max_len), tokens.device, params["embedding"])
    x = _embed_tokens(params, tokens, cfg, torch.arange(s, device=tokens.device))
    x = _decoder_stack(params, x, enc, cfg, cache, None)
    return _logits(params, x[:, -1]), cache


def decode_step(params: Tree, cache: Tree, tokens: torch.Tensor, cur_index,
                cfg: ModelConfig, **_) -> torch.Tensor:
    """tokens [B] at the one position ``cur_index`` (an int or a 0-d
    tensor: the JAX package's decode takes a scalar) -> logits [B,V]
    float32; the self cache is written in place."""
    if isinstance(cur_index, torch.Tensor):
        if cur_index.dim():
            raise ValueError(f"{cfg.name}: decode takes one scalar cur_index for "
                             f"the batch, not a {tuple(cur_index.shape)} vector (the "
                             f"encoder-decoder cache is built per request)")
        cur_index = int(cur_index)
    if not 0 <= cur_index < cache["decoder"][0].shape[3]:
        raise ValueError(f"cur_index {cur_index} outside the cache")
    pos = torch.full((1,), cur_index, device=tokens.device)
    x = _embed_tokens(params, tokens[:, None], cfg, pos)
    x = _decoder_stack(params, x, None, cfg, cache, cur_index)
    return _logits(params, x[:, 0])


def loss_fn(params: Tree, batch: Tree, cfg: ModelConfig, **_):
    """batch: frames [B, F, D], tokens [B,S], labels [B,S] -> (ce, {"ce",
    "aux": 0.0}): the encoder over the frames, the decoder in training
    mode, the cross entropy through the embedding's transpose."""
    tokens = batch["tokens"]
    frames = batch["frames"].to(device=tokens.device, dtype=params["embedding"].dtype)
    enc = encode(params, frames, cfg, remat=True)
    x = _embed_tokens(params, tokens, cfg, torch.arange(tokens.shape[1],
                                                        device=tokens.device))
    x = _decoder_stack(params, x, enc, cfg, None, None)
    ce = L.chunked_cross_entropy(x, params["embedding"].T, batch["labels"])
    return ce, {"ce": ce, "aux": 0.0}


def make_decode_cache(params: Tree, frames: torch.Tensor, cfg: ModelConfig,
                      max_len: int) -> Tree:
    """Encode the (stub) frames and build a decode-ready cache: zero self
    K/V of ``max_len`` positions and each layer's cross K/V from the
    encoder, computed one layer at a time in the model's type."""
    enc = encode(params, frames, cfg)
    cache = zeros(abstract_cache(cfg, frames.shape[0], max_len), frames.device,
                  params["embedding"])
    _, _, xk, xv = cache["decoder"]
    for i, lp in enumerate(params["decoder"]):
        kx, vx = _cross_kv(enc, lp)
        xk[i].copy_(kx.transpose(1, 2))
        xv[i].copy_(vx.transpose(1, 2))
    return cache

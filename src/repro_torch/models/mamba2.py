"""Mamba2 (SSD) blocks and the Zamba2 hybrid (arXiv:2411.15242): prefill
and decode steps for serving.

Mamba2 block: in-proj -> (z, xBC, dt); depthwise causal conv over xBC;
selective state-space recurrence

    S_t = exp(dt_t * A) S_{t-1} + (dt_t x_t) B_t^T ,   y_t = S_t C_t + D x_t

with a scalar A per head; gated RMSNorm; out-proj.

Zamba2: a stack of Mamba2 layers with ONE shared transformer block
(attention and SwiGLU, the same weights at each place) after every
``hybrid_attn_every`` Mamba2 layers, then the tail layers that do not fill
a period.  The shared block is the transformer's attention sub-block and
SwiGLU (``models/transformer.py``), with its own KV cache at each place it
runs.

Weights keep the JAX tree's names and shapes (``abstract_params``); the
stacked ``layers`` leaves reach this module as a list of per-layer views
(``repro_torch.convert.to_port_layout``); ``shared`` has no layer axis.
The decode state is the JAX tree: ``{"mamba": (conv [L, B, conv_dim, 3]
in the model's type, ssd [L, B, H, P, N] float32), "attn": (k, v) [n_p, B,
KV, S, hd]}``.  Unlike the JAX functions, which return a new cache,
``prefill`` fills a zeroed cache of ``max_len`` positions and
``decode_step`` advances the cache it is given in place.

``loss_fn`` is the training path: the same stack from zero states and
with no cache, each Mamba2 layer and each place of the shared block under
``torch.utils.checkpoint``, then the chunked cross entropy; the shared
block's attention differentiates through the flash backward kernel.

Everything here but the shared block's attention is plain PyTorch, as it is
plain jnp in the JAX package (which has no kernel for ``ssd_scan``): the
prefill's recurrence runs step by step in float32, in the JAX scan's
order.  The shared block's prefill runs through the causal flash kernel,
its decode through flash-decode, with ``cur_index`` an int or a [B] vector.
A decode step's arithmetic per row does not depend on the batch: its
reductions (the RMS norms, the conv over 4 taps, the SSD read over the
state) run over at least ``layers.MIN_REDUCE_ROWS`` rows as elementwise
products and sums, never as a batched matrix product.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.param import ParamSpec, constrain, tree_map, zeros

Tree = Dict[str, Any]
CONV_WIDTH = 4
N_GROUPS = 1


def _dims(cfg: ModelConfig):
    d_inner = cfg.d_inner
    n_heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * N_GROUPS * cfg.ssm_state
    d_in_proj = 2 * d_inner + 2 * N_GROUPS * cfg.ssm_state + n_heads
    return d_inner, n_heads, conv_dim, d_in_proj


def mamba_param_specs(cfg: ModelConfig, nl: int) -> Tree:
    dt = cfg.dtype
    d = cfg.d_model
    d_inner, n_heads, conv_dim, d_in_proj = _dims(cfg)
    return {
        "norm": ParamSpec((nl, d), ("layers", "embed"), dt, "zeros"),
        "w_in": ParamSpec((nl, d, d_in_proj), ("layers", "embed", "ssm_inner"), dt),
        "conv_w": ParamSpec((nl, conv_dim, CONV_WIDTH), ("layers", "ssm_inner", None), dt),
        "conv_b": ParamSpec((nl, conv_dim), ("layers", "ssm_inner"), dt, "zeros"),
        "dt_bias": ParamSpec((nl, n_heads), ("layers", "ssm_heads"), "float32", "zeros"),
        "a_log": ParamSpec((nl, n_heads), ("layers", "ssm_heads"), "float32", "zeros"),
        "d_skip": ParamSpec((nl, n_heads), ("layers", "ssm_heads"), "float32", "ones"),
        "gn_w": ParamSpec((nl, d_inner), ("layers", "ssm_inner"), dt, "zeros"),
        "w_out": ParamSpec((nl, d_inner, d), ("layers", "ssm_inner", "embed"), dt),
    }


# ----------------------------------------------------------------- ssd core
def ssd_step(x, dt, a, B, C, state):
    """One token: x [B,H,P], dt/a [B,H], B/C [B,N], state [B,H,P,N] ->
    (y [B,H,P], state).  The state's outer-product update and its read
    against C are elementwise products and a sum over N."""
    state = a[..., None, None] * state + (x * dt[..., None])[..., None] * B[:, None, None, :]
    y = (state * C[:, None, None, :]).sum(dim=-1)
    return y, state


def ssd_scan(x, dt, a, B, C, state):
    """x: [B,T,H,P]; dt/a: [B,T,H]; B/C: [B,T,N]; state: [B,H,P,N].
    Returns (y [B,T,H,P], final state): ``ssd_step`` over t = 0..T-1, the
    order of the JAX package's scan (which chunks only so that its backward
    can checkpoint)."""
    ys = []
    for t in range(x.shape[1]):
        y, state = ssd_step(x[:, t], dt[:, t], a[:, t], B[:, t], C[:, t], state)
        ys.append(y)
    return torch.stack(ys, dim=1), state


def _causal_conv_seq(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x: [B,T,C], w: [C,W]: the sum, from 0, of the
    input shifted by W-1-i positions times tap i, then the bias."""
    t = x.shape[1]
    out = 0
    for i in range(CONV_WIDTH):
        out = out + F.pad(x, (0, 0, CONV_WIDTH - 1 - i, i))[:, :t] * w[None, None, :, i]
    return out + b[None, None]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(exp(x) + 1) as logaddexp(x, 0), at every x
    (``F.softplus`` returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gated_norm(y, z, w, eps):
    return L.rms_norm(y * F.silu(z), w, eps)


def mamba_layer(x: torch.Tensor, lp: Tree, cfg: ModelConfig, cache, seq_mode: bool):
    """x [B,T,D]; cache: (conv_state [B,conv_dim,W-1], ssd_state [B,H,P,N]).
    Returns (x + the block's output, (new conv state, new ssd state)).  The
    conv state keeps the last W-1 raw (pre-conv) xBC inputs."""
    bsz, t, _ = x.shape
    d_inner, n_heads, conv_dim, _ = _dims(cfg)
    hd, ns = cfg.ssm_head_dim, cfg.ssm_state
    conv_state, ssd_state = cache

    xn = L.rms_norm(x, lp["norm"], cfg.norm_eps)
    zxbcdt = xn @ lp["w_in"]
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt_raw = zxbcdt[..., d_inner + conv_dim:]   # [B,T,H]

    if seq_mode:
        xBC_conv = F.silu(_causal_conv_seq(xBC, lp["conv_w"], lp["conv_b"]))
        if t >= CONV_WIDTH - 1:
            new_conv = xBC[:, -(CONV_WIDTH - 1):].transpose(1, 2)
        else:
            new_conv = torch.cat([conv_state, xBC.transpose(1, 2)],
                                 dim=-1)[..., -(CONV_WIDTH - 1):]
    else:
        hist = torch.cat([conv_state, xBC.transpose(1, 2)], dim=-1)   # [B,C,W]
        out = (hist * lp["conv_w"][None]).sum(dim=-1) + lp["conv_b"][None]
        xBC_conv = F.silu(out)[:, None]
        new_conv = hist[..., 1:]

    xs = xBC_conv[..., :d_inner].reshape(bsz, t, n_heads, hd)
    Bm = xBC_conv[..., d_inner:d_inner + ns].float()
    Cm = xBC_conv[..., d_inner + ns:].float()
    dtv = _softplus(dt_raw.float() + lp["dt_bias"])
    a = torch.exp(-torch.exp(lp["a_log"]) * dtv)   # [B,T,H]
    xs32 = xs.float()
    if seq_mode:
        y, new_ssd = ssd_scan(xs32, dtv, a, Bm, Cm, ssd_state)
    else:
        y, new_ssd = ssd_step(xs32[:, 0], dtv[:, 0], a[:, 0], Bm[:, 0], Cm[:, 0],
                              ssd_state)
        y = y[:, None]
    y = y + lp["d_skip"][None, None, :, None] * xs32
    y = y.reshape(bsz, t, d_inner).to(x.dtype)
    out = _gated_norm(y, z, lp["gn_w"], cfg.norm_eps) @ lp["w_out"]
    return constrain(x + out, "batch", "seq_res", "act_embed"), (new_conv, new_ssd)


# ------------------------------------------------------- zamba2 shared block
def shared_block_specs(cfg: ModelConfig) -> Tree:
    """The transformer's attention and MLP specs without the layer axis."""
    p = transformer._attn_specs(cfg, 1, cfg.dtype)
    p.update(transformer._mlp_specs(cfg, 1, cfg.dtype))
    return tree_map(lambda s: ParamSpec(s.shape[1:], s.logical[1:], s.dtype, s.init), p)


def _shared_block(x: torch.Tensor, sp: Tree, cfg: ModelConfig, cache,
                  cur_index) -> torch.Tensor:
    """The shared block at one place: ``cache`` is that place's (k, v)
    [B,KV,S,hd], written in place, or None in training; ``cur_index`` None
    is the prefill, an int or a [B] vector a decode step (per-row
    positions)."""
    b, s = x.shape[:2]
    if cur_index is None:
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    elif isinstance(cur_index, torch.Tensor):
        positions = cur_index.to(x.device)[:, None]
    else:
        positions = torch.full((b, 1), cur_index, device=x.device)
    sincos = transformer._sincos(cfg, positions)
    x = x + transformer._attention(x, sp, cfg, sincos, cache, cur_index, 0)
    h = L.rms_norm(x, sp["mlp_norm"], cfg.norm_eps)
    return constrain(x + L.swiglu(h, sp["w_gate"], sp["w_up"], sp["w_down"]),
                     "batch", "seq_res", "act_embed")


# ------------------------------------------------------------------ zamba2
def abstract_params(cfg: ModelConfig) -> Tree:
    dt = cfg.dtype
    p: Tree = {
        "embedding": ParamSpec((cfg.vocab_padded, cfg.d_model), ("vocab", "embed"), dt, "small"),
        "final_norm": ParamSpec((cfg.d_model,), ("embed",), dt, "zeros"),
        "unembed": ParamSpec((cfg.d_model, cfg.vocab_padded), ("embed", "vocab"), dt, "small"),
        "layers": mamba_param_specs(cfg, cfg.num_layers),
    }
    if cfg.hybrid_attn_every:
        p["shared"] = shared_block_specs(cfg)
    return p


def _periods(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(periods, Mamba2 layers a period, tail layers): zamba2-1.2b (6, 6, 2)."""
    every = cfg.hybrid_attn_every or cfg.num_layers
    return cfg.num_layers // every, every, cfg.num_layers % every


def abstract_cache(cfg: ModelConfig, batch: int, seq_len: int) -> Tree:
    _, n_heads, conv_dim, _ = _dims(cfg)
    n_p, _, _ = _periods(cfg)
    nl = cfg.num_layers
    c: Tree = {
        "mamba": (
            ParamSpec((nl, batch, conv_dim, CONV_WIDTH - 1),
                      ("layers", "batch", "ssm_inner", None), cfg.dtype, "zeros"),
            ParamSpec((nl, batch, n_heads, cfg.ssm_head_dim, cfg.ssm_state),
                      ("layers", "batch", "ssm_heads", None, None), "float32", "zeros"),
        )
    }
    if cfg.hybrid_attn_every and n_p:
        kv, hd = cfg.resolved_kv_heads, cfg.resolved_head_dim
        shape = (n_p, batch, kv, seq_len, hd)
        logical = ("layers", "batch", "cache_kv_heads", "cache_seq", None)
        cd = cfg.resolved_cache_dtype
        c["attn"] = (ParamSpec(shape, logical, cd, "zeros"),
                     ParamSpec(shape, logical, cd, "zeros"))
    return c


def _train_layer(x, lp, cfg: ModelConfig, zero_state):
    return mamba_layer(x, lp, cfg, zero_state, True)[0]


def _stack(params: Tree, x: torch.Tensor, cfg: ModelConfig, cache: Optional[Tree],
           cur_index) -> torch.Tensor:
    """Every Mamba2 layer, the shared block after each full period, then the
    tail layers; each layer's state and each place's KV written into
    ``cache`` in place.  ``cur_index`` None is the prefill; with ``cache``
    None too, the training forward: zero states, nothing written, each
    layer and each shared-block place under ``torch.utils.checkpoint``."""
    n_p, every, _ = _periods(cfg)
    shared = params.get("shared")
    if cache is None:
        spec = abstract_cache(cfg, x.shape[0], 0)["mamba"]
        zero_state = tuple(torch.zeros(s.shape[1:], dtype=getattr(torch, s.dtype),
                                       device=x.device) for s in spec)
    for i, lp in enumerate(params["layers"]):
        if cache is None:
            x = checkpoint(_train_layer, x, lp, cfg, zero_state, use_reentrant=False)
        else:
            conv, ssd = cache["mamba"]
            x, (nc, nst) = mamba_layer(x, lp, cfg, (conv[i], ssd[i]), cur_index is None)
            conv[i].copy_(nc)
            ssd[i].copy_(nst)
        p = (i + 1) // every - 1
        if shared is not None and (i + 1) % every == 0 and p < n_p:
            if cache is None:
                x = checkpoint(_shared_block, x, shared, cfg, None, None,
                               use_reentrant=False)
            else:
                x = _shared_block(x, shared, cfg, tuple(c[p] for c in cache["attn"]),
                                  cur_index)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


# ----------------------------------------------------------------- public API
def prefill(params: Tree, tokens: torch.Tensor, cfg: ModelConfig, *,
            max_len: Optional[int] = None, **_):
    """tokens [B,S] -> (last-token logits [B,V] float32, cache with
    ``max_len`` positions in the shared block's KV, default S).  The
    transformer's keywords (``dropless``, ``patch_embeds``) are ignored, as
    the JAX package's prefill ignores them."""
    b, s = tokens.shape
    max_len = s if max_len is None else max_len
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    cache = zeros(abstract_cache(cfg, b, max_len), tokens.device, params["embedding"])
    x = _stack(params, L.embed(params["embedding"], tokens), cfg, cache, None)
    return (x[:, -1] @ params["unembed"]).float(), cache


def loss_fn(params: Tree, batch: Tree, cfg: ModelConfig, **_):
    """batch: tokens [B,S], labels [B,S] -> (ce, {"ce", "aux": 0.0})."""
    x = constrain(L.embed(params["embedding"], batch["tokens"]), "batch", "seq_res",
                  "act_embed")
    x = _stack(params, x, cfg, None, None)
    ce = L.chunked_cross_entropy(x, params["unembed"], batch["labels"])
    return ce, {"ce": ce, "aux": 0.0}


def decode_step(params: Tree, cache: Tree, tokens: torch.Tensor, cur_index,
                cfg: ModelConfig, **_) -> torch.Tensor:
    """tokens [B] at positions ``cur_index`` (an int, or a [B] tensor on the
    tokens' device) -> logits [B,V] float32; the cache advances in place."""
    if not isinstance(cur_index, torch.Tensor) and "attn" in cache:
        if not 0 <= cur_index < cache["attn"][0].shape[3]:
            raise ValueError(f"cur_index {cur_index} outside the cache")
    x = _stack(params, L.embed(params["embedding"], tokens[:, None]), cfg, cache, cur_index)
    return (x[:, 0] @ params["unembed"]).float()

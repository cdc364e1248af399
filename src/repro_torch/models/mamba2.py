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
plain jnp in the JAX package (which has no kernel for ``ssd_scan``): a
sequence's recurrence (prefill and training) runs in float32 in the chunked
matrix form (``ssd_scan_log``: chunks of ``SSD_CHUNK`` positions, the state
carried from chunk to chunk), a decode step's is ``ssd_step``.  The shared
block's prefill runs through the causal flash kernel, its decode through
flash-decode, with ``cur_index`` an int or a [B] vector.  A row's
arithmetic does not depend on the batch: a prefill's recurrence runs row by
row (``_ssd_rows``), and a decode step's reductions (the RMS norms, the conv
over 4 taps, the SSD read over the state) run over at least
``layers.MIN_REDUCE_ROWS`` rows as elementwise products and sums, never as
a batched matrix product.  Under a partitioner the in-projection
(column-parallel), the out-projection (row-parallel over the heads) and the
recurrence (heads over ``model``) run on each rank's shards.
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
from repro_torch.sharding import local as shard_local

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


#: positions a chunk of ``ssd_scan``: the loop over chunks takes T/64 turns
#: (512 at 32,768 positions), the decay matrix of a chunk holds 64 x 64
#: entries a head, and the intra-chunk product's 2 Q H P flops a position
#: match the state read's 2 H P N at zamba2's N of 64; a served prompt of
#: 64-256 tokens is 1-4 chunks.
SSD_CHUNK = 64


def ssd_scan(x, dt, a, B, C, state, chunk: int = SSD_CHUNK):
    """x: [B,T,H,P]; dt/a: [B,T,H]; B/C: [B,T,N]; state: [B,H,P,N].
    Returns (y [B,T,H,P], final state): ``ssd_scan_log`` of log a.  A decay
    of exactly 0 is a log of -inf, which the forward takes; a path that
    differentiates passes its log-decay to ``ssd_scan_log`` itself, since
    the gradient of log a at 0 is not finite."""
    return ssd_scan_log(x, dt, torch.log(a), B, C, state, chunk)


def ssd_scan_log(x, dt, la, B, C, state, chunk: int = SSD_CHUNK):
    """The recurrence of ``ssd_step`` over t = 0..T-1 from the log-decays la
    = log a [B,T,H], in the chunked matrix form, all in the inputs' type.
    In a chunk of Q positions (``min(chunk, T)``; the last one padded with
    positions of no input and decay 1), with seg[i, j] the sum of la_k over
    j < k <= i and cum[i] = seg[i, -1] + la_0 the sum from the chunk's
    start:

        y_i = sum_{j <= i} (C_i . B_j) exp(seg[i, j]) dt_j x_j
              + exp(cum[i]) (s_in C_i)
        s_out = exp(cum[Q-1]) s_in + sum_j exp(seg[Q-1, j]) dt_j x_j B_j^T

    seg is a masked cumulative sum, never a difference of two (which gives
    -inf - -inf once a decay underflows), so a log-decay of -inf or one far
    below gives a decay of 0 and a finite gradient.  The products run per
    chunk over the batch; the states pass from chunk to chunk in a loop of
    T/Q turns."""
    b, t, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, t)
    nc = -(-t // q)
    xdt = x * dt[..., None]
    pad = nc * q - t
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        la = F.pad(la, (0, 0, 0, pad))
        B, C = F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad))
    xdt = xdt.reshape(b, nc, q, h, p).transpose(2, 3)     # [b,c,h,q,p]
    la = la.reshape(b, nc, q, h).transpose(2, 3)          # [b,c,h,q]
    Bc, Cc = B.reshape(b, nc, 1, q, n), C.reshape(b, nc, 1, q, n)
    below = torch.ones(q, q, dtype=torch.bool, device=x.device).tril(-1)
    seg = la[..., :, None].expand(*la.shape, q).masked_fill(~below, 0).cumsum(dim=-2)
    decay = torch.exp(seg.masked_fill(below.T, float("-inf")))   # 0 above the diagonal
    cum = la.cumsum(dim=-1)                               # [b,c,h,q]
    # the chunk's own inputs: its outputs, and its part of the end state
    y = ((Cc @ Bc.transpose(-1, -2)) * decay) @ xdt       # [b,c,h,q,p]
    own = (xdt * decay[..., -1, :, None]).transpose(-1, -2) @ Bc   # [b,c,h,p,n]
    # the states carried in, chunk by chunk
    total = torch.exp(cum[..., -1])[..., None, None]      # [b,c,h,1,1]
    s_in = []
    for c in range(nc):
        s_in.append(state)
        state = total[:, c] * state + own[:, c]
    carried = Cc @ torch.stack(s_in, dim=1).transpose(-1, -2)      # [b,c,h,q,p]
    y = y + torch.exp(cum)[..., None] * carried
    return y.transpose(2, 3).reshape(b, nc * q, h, p)[:, :t], state


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


def _ssd_rows(x, dt, la, B, C, state):
    """``ssd_scan_log`` row by row: each row's products at the shape they
    have alone, whatever the batch (a served prefill must equal the
    request's solo one bit for bit, and cuBLAS may pick a batched
    product's algorithm, and its sums' order, by the batch)."""
    ys, states = zip(*(ssd_scan_log(*(v[i:i + 1] for v in (x, dt, la, B, C, state)))
                       for i in range(x.shape[0])))
    return torch.cat(ys), torch.cat(states)


def _ssd(x, dt, la, B, C, state, rows: bool):
    """The sequence's SSD recurrence (``ssd_scan_log``; ``rows``: row by
    row); sharded, on each rank's shards (``sharding.local.ssd``)."""
    scan = _ssd_rows if rows else ssd_scan_log
    if shard_local.sharded(x):
        return shard_local.ssd(scan, x, dt, la, B, C, state)
    return scan(x, dt, la, B, C, state)


def mamba_layer(x: torch.Tensor, lp: Tree, cfg: ModelConfig, cache, seq_mode: bool,
                train: bool = False):
    """x [B,T,D]; cache: (conv_state [B,conv_dim,W-1], ssd_state [B,H,P,N]).
    Returns (x + the block's output, (new conv state, new ssd state)).  The
    conv state keeps the last W-1 raw (pre-conv) xBC inputs.  A sequence's
    recurrence runs from the log-decays (finite, so is their gradient);
    outside ``train`` row by row, so that a row's bits do not depend on the
    batch."""
    bsz, t, _ = x.shape
    d_inner, n_heads, conv_dim, _ = _dims(cfg)
    hd, ns = cfg.ssm_head_dim, cfg.ssm_state
    conv_state, ssd_state = cache

    xn = L.rms_norm(x, lp["norm"], cfg.norm_eps)
    # x @ w_in (sharded, column-parallel: ``layers.project_heads``)
    zxbcdt = L.project_heads(xn, lp["w_in"].view(cfg.d_model, -1, 1)).view(bsz, t, -1)
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:d_inner + conv_dim]
    dt_raw = zxbcdt[..., d_inner + conv_dim:]   # [B,T,H]

    if seq_mode:
        # sharded, on each rank's rows: torch 2.11 cannot pad this DTensor
        if shard_local.sharded(xBC):
            xBC_conv = shard_local.rows(_causal_conv_seq, (xBC,), (lp["conv_w"], lp["conv_b"]))
        else:
            xBC_conv = _causal_conv_seq(xBC, lp["conv_w"], lp["conv_b"])
        xBC_conv = F.silu(xBC_conv)
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
    la = -torch.exp(lp["a_log"]) * dtv   # [B,T,H], the log of the decays
    xs32 = xs.float()
    if seq_mode:
        y, new_ssd = _ssd(xs32, dtv, la, Bm, Cm, ssd_state, rows=not train)
    else:
        y, new_ssd = ssd_step(xs32[:, 0], dtv[:, 0], torch.exp(la[:, 0]), Bm[:, 0],
                              Cm[:, 0], ssd_state)
        y = y[:, None]
    y = y + lp["d_skip"][None, None, :, None] * xs32
    y = y.reshape(bsz, t, d_inner).to(x.dtype)
    # g @ w_out (sharded, row-parallel over the heads: ``layers.merge_heads``)
    out = L.merge_heads(_gated_norm(y, z, lp["gn_w"], cfg.norm_eps).view(bsz, t, n_heads, hd),
                        lp["w_out"].view(n_heads, hd, cfg.d_model))
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
    return mamba_layer(x, lp, cfg, zero_state, True, train=True)[0]


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
        zero_state = zeros(tuple(ParamSpec(s.shape[1:], s.logical[1:], s.dtype, s.init)
                                 for s in spec), x.device, x)
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

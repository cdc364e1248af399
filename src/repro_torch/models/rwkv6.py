"""RWKV6 "Finch" (arXiv:2404.05892): attention-free, data-dependent decay;
prefill and decode steps for serving.

Per layer: a TimeMix block (token-shift ddlerp and the WKV6 linear-attention
recurrence with per-channel data-dependent decay w_t and bonus u) and a
ChannelMix block (token shift and a squared-ReLU FFN).  The WKV recurrence
carries a state S [H, K, V] per sequence:

    y_t = S^T r_t + (u . k_t . r_t) v_t
    S  <- diag(w_t) S + k_t v_t^T

Weights keep the JAX tree's names, shapes, logical axes and init rules
(``abstract_params``); the stacked ``[L, ...]`` leaves reach this module as
a list of per-layer views (``repro_torch.convert.to_port_layout``).  The
JAX package's deviations from the reference implementation are kept:
RMSNorm instead of LayerNorm, and one shared rank-32 LoRA producing all five
ddlerp deltas.

The decode state is the JAX tree too: ``{"rwkv": (xp_att, xp_ffn, S)}`` with
the token-shift leaves [L, B, D] in the model's type and S [L, B, H, K, K]
in float32, batch axis 1 on every leaf, the same size at any prompt length.
Unlike the JAX functions, which return a new cache, ``decode_step`` writes
the cache it is given in place; ``prefill`` returns a fresh one
(``max_len`` has no meaning for a state that does not grow).  ``cur_index``
is accepted and ignored: the state holds the position.

The prefill's recurrence runs through the hand-written WKV6 kernel for any
prompt length (``kernels.wkv6``: the CUDA kernel for a CUDA tensor, its
plain version on the CPU).  A decode step stays plain PyTorch (``wkv6_step``),
as the JAX package keeps it out of the kernel.

``loss_fn`` is the training path: every layer from a zero state, under
``torch.utils.checkpoint``, and the chunked cross entropy.  On the CPU the
recurrence is the plain version, which autograd differentiates; on the card
the WKV6 forward kernel with the WKV6 backward kernel as its gradient
(``kernels.wkv6_backward``): a layer launches the forward twice a step (its
forward and the recompute under checkpointing) and the backward once.

Under a partitioner the weights and the state are DTensors, the activations
held to the JAX package's layouts by ``constrain``, and the recurrence runs
on each rank's shards (heads over ``model``) through ``local_map``, as do
the token-shift mix and decay (rows split by batch, the small weights
whole), the projections (column- and row-parallel over the heads) and the
channel mix's FFN: DTensor alone lays their products out op by op, and on
a 2x16x16 mesh it searched for minutes an op.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import wkv6
from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec, constrain, zeros
from repro_torch.sharding import local as shard_local

Tree = Dict[str, Any]
LORA_MIX = 32
LORA_DECAY = 64
GROUP_NORM_EPS = 64e-5


def abstract_params(cfg: ModelConfig) -> Tree:
    dt = cfg.dtype
    d, f, nl = cfg.d_model, cfg.d_ff, cfg.num_layers
    h, k = cfg.num_heads, cfg.resolved_head_dim

    layer = {
        "ln_att": ParamSpec((nl, d), ("layers", "embed"), dt, "zeros"),
        "ln_ffn": ParamSpec((nl, d), ("layers", "embed"), dt, "zeros"),
        # ddlerp token-shift mixing
        "mu_x": ParamSpec((nl, d), ("layers", "embed"), dt, "zeros"),
        "mu_rkvwg": ParamSpec((nl, 5, d), ("layers", None, "embed"), dt, "zeros"),
        "lora_a": ParamSpec((nl, d, 5 * LORA_MIX), ("layers", "embed", None), dt),
        "lora_b": ParamSpec((nl, 5, LORA_MIX, d), ("layers", None, None, "embed"), dt, "small"),
        # data-dependent decay
        "w0": ParamSpec((nl, d), ("layers", "embed"), dt, "zeros"),
        "wa": ParamSpec((nl, d, LORA_DECAY), ("layers", "embed", None), dt),
        "wb": ParamSpec((nl, LORA_DECAY, d), ("layers", None, "embed"), dt, "small"),
        "bonus_u": ParamSpec((nl, h, k), ("layers", "ssm_heads", None), dt, "zeros"),
        # projections
        "w_r": ParamSpec((nl, d, d), ("layers", "embed", "ssm_inner"), dt),
        "w_k": ParamSpec((nl, d, d), ("layers", "embed", "ssm_inner"), dt),
        "w_v": ParamSpec((nl, d, d), ("layers", "embed", "ssm_inner"), dt),
        "w_g": ParamSpec((nl, d, d), ("layers", "embed", "ssm_inner"), dt),
        "w_o": ParamSpec((nl, d, d), ("layers", "ssm_inner", "embed"), dt),
        "gn_w": ParamSpec((nl, d), ("layers", "embed"), dt, "zeros"),
        # channel mix
        "mu_k2": ParamSpec((nl, d), ("layers", "embed"), dt, "zeros"),
        "mu_r2": ParamSpec((nl, d), ("layers", "embed"), dt, "zeros"),
        "w_k2": ParamSpec((nl, d, f), ("layers", "embed", "mlp"), dt),
        "w_v2": ParamSpec((nl, f, d), ("layers", "mlp", "embed"), dt),
        "w_r2": ParamSpec((nl, d, d), ("layers", "embed", "ssm_inner"), dt),
    }
    return {
        "embedding": ParamSpec((cfg.vocab_padded, d), ("vocab", "embed"), dt, "small"),
        "final_norm": ParamSpec((d,), ("embed",), dt, "zeros"),
        "unembed": ParamSpec((d, cfg.vocab_padded), ("embed", "vocab"), dt, "small"),
        "layers": layer,
    }


def abstract_cache(cfg: ModelConfig, batch: int, seq_len: int) -> Tree:
    """The decode state's ParamSpec tree: the same size at any ``seq_len``."""
    d, h, k, nl = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim, cfg.num_layers
    return {
        "rwkv": (
            ParamSpec((nl, batch, d), ("layers", "batch", "act_embed"), cfg.dtype, "zeros"),
            ParamSpec((nl, batch, d), ("layers", "batch", "act_embed"), cfg.dtype, "zeros"),
            ParamSpec((nl, batch, h, k, k), ("layers", "batch", "ssm_heads", None, None),
                      "float32", "zeros"),
        )
    }


# ------------------------------------------------------------------ wkv core
def wkv6_step(r, k, v, w, u, state):
    """One decode step, plain PyTorch in float32.  r/k/v/w: [B,H,K]; u:
    [H,K]; state: [B,H,K,V] float32.  Returns (y [B,H,V] float32, state).

    Both sums run over one axis of elementwise products, over B*H >= 64
    rows at rwkv6-7b's widths (``layers.MIN_REDUCE_ROWS``), so each row's
    arithmetic does not depend on the batch it decodes in."""
    rf, kf, vf, wf, uf = (x.float() for x in (r, k, v, w, u))
    y = (rf[..., None] * state).sum(dim=-2)
    y = y + (uf[None] * kf * rf).sum(dim=-1, keepdim=True) * vf
    state = wf[..., None] * state + kf[..., None] * vf[:, :, None, :]
    return y, state


def _group_norm(x: torch.Tensor, w: torch.Tensor, h: int,
                eps: float = GROUP_NORM_EPS) -> torch.Tensor:
    """Per-head LayerNorm over the value dim (RWKV GroupNorm(H)), scaled by
    ``1 + w``, in float32."""
    b, t, d = x.shape
    xh = x.reshape(b, t, h, d // h).float()
    mu = L.row_mean(xh)
    var = L.row_mean((xh - mu) ** 2)
    xh = (xh - mu) * torch.rsqrt(var + eps)
    return (xh.reshape(b, t, d) * (1.0 + w.float())).to(x.dtype)


# -------------------------------------------------------------------- blocks
def _shifted(xn: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """The token shift: each position's predecessor, ``x_prev`` before the
    first."""
    return torch.cat([x_prev[:, None], xn[:, :-1]], dim=1)


def _ddlerp(x, xx, lp, matmul=torch.matmul):
    """Data-dependent lerp producing the (r, k, v, w, g) inputs
    [B,T,5,D].  x/xx: [B,T,D]."""
    delta = xx - x
    base = x + delta * lp["mu_x"]
    lora = torch.tanh(matmul(base, lp["lora_a"]))   # [B,T,5*R]
    b, t, _ = lora.shape
    lora = lora.reshape(b, t, 5, LORA_MIX)
    dd = torch.einsum("btcr,crd->btcd", lora, lp["lora_b"])
    mix = lp["mu_rkvwg"][None, None] + dd
    return x[:, :, None] + delta[:, :, None] * mix


#: the small weights of the token-shift mix and the decay's LoRA
MIX_WEIGHTS = ("mu_x", "lora_a", "lora_b", "mu_rkvwg", "w0", "wa", "wb")


def _mix_and_decay(xn, xx, *weights, matmul=torch.matmul):
    """-> (the (r, k, v, w, g) inputs [B,T,5,D] (``_ddlerp``), the decays
    [B,T,D]): exp(-exp(w0 + tanh(xw @ wa) @ wb)) in float32, cast to the
    model's type before the recurrence, as the JAX package does.
    ``weights`` are ``MIX_WEIGHTS``."""
    lp = dict(zip(MIX_WEIGHTS, weights))
    mixed = _ddlerp(xn, xx, lp, matmul)
    w = torch.exp(-torch.exp(
        (lp["w0"] + torch.tanh(matmul(mixed[:, :, 3], lp["wa"])) @ lp["wb"]).float()
    )).to(xn.dtype)
    return mixed, w


def _time_mix(x, lp, cfg: ModelConfig, x_prev, wkv_state, seq_mode: bool):
    """Returns (out, new x_prev, new wkv state).  The token shift reads the
    normed input, and the new x_prev is its last position."""
    b, t, d = x.shape
    h, kdim = cfg.num_heads, cfg.resolved_head_dim
    xn = L.rms_norm(x, lp["ln_att"], cfg.norm_eps)
    xx = _shifted(xn, x_prev) if seq_mode else x_prev[:, None]
    # a decode step's two skinny projections (to the 5 x 32 LoRA inputs and
    # to the 64 decay inputs): a decay that rounds the other way in bfloat16
    # would move the recurrent state
    skinny = torch.matmul if seq_mode else L.row_blocks_matmul
    mix = partial(_mix_and_decay, matmul=skinny)
    weights = [lp[name] for name in MIX_WEIGHTS]
    if shard_local.sharded(xn):
        mixed, w = shard_local.rows(mix, (xn, xx), weights, outputs=2)
    else:
        mixed, w = mix(xn, xx, *weights)
    w = w.reshape(b, t, h, kdim)
    xr, xk, xv, xg = (mixed[:, :, i] for i in (0, 1, 2, 4))
    r, kk, vv, g = (L.project_heads(xi, lp[name].view(d, h, kdim))
                    for xi, name in ((xr, "w_r"), (xk, "w_k"), (xv, "w_v"), (xg, "w_g")))
    g = F.silu(g)
    r = constrain(r, "batch", "seq", "ssm_heads", None)
    if seq_mode and shard_local.sharded(r):
        y, new_state = shard_local.wkv6(wkv6, r, kk, vv, w, lp["bonus_u"], wkv_state)
    elif seq_mode:
        y, new_state = wkv6(r, kk, vv, w, lp["bonus_u"], wkv_state)
    else:
        y, new_state = wkv6_step(r[:, 0], kk[:, 0], vv[:, 0], w[:, 0],
                                 lp["bonus_u"], wkv_state)
        y = y[:, None]
    y = _group_norm(y.reshape(b, t, d).to(x.dtype), lp["gn_w"], h).view(b, t, h, kdim)
    # sharded, the products' partial sums reduced before the residual add
    out = constrain(L.merge_heads(y * g, lp["w_o"].view(h, kdim, d)).to(x.dtype),
                    "batch", "seq", "act_embed")
    return out, xn[:, -1], new_state


def _channel_mix(x, lp, cfg: ModelConfig, x_prev, seq_mode: bool):
    b, t, d = x.shape
    xn = L.rms_norm(x, lp["ln_ffn"], cfg.norm_eps)
    xx = _shifted(xn, x_prev) if seq_mode else x_prev[:, None]
    delta = xx - xn
    xk = xn + delta * lp["mu_k2"]
    xr = xn + delta * lp["mu_r2"]
    if shard_local.sharded(xk):
        kv = shard_local.mlp(_squared_relu_ffn, xk, (lp["w_k2"],), lp["w_v2"])
    else:
        kv = _squared_relu_ffn(xk, lp["w_k2"], lp["w_v2"])
    h = cfg.num_heads
    gate = L.project_heads(xr, lp["w_r2"].view(d, h, d // h)).view(b, t, d)
    out = torch.sigmoid(gate) * constrain(kv, "batch", "seq", "act_embed")
    return out, xn[:, -1]


def _squared_relu_ffn(x, w_k2, w_v2):
    """relu(x @ w_k2)^2 @ w_v2."""
    kk = torch.square(torch.relu(x @ w_k2))
    kk = constrain(kk, "batch", "seq", "act_mlp")
    return kk @ w_v2


def _layer(x, lp, cfg: ModelConfig, xp_att, xp_ffn, st, seq_mode: bool):
    """-> (x after the layer, new x_prev of each block, new wkv state)."""
    att, nxa, nst = _time_mix(x, lp, cfg, xp_att, st, seq_mode)
    x = x + att
    ffn, nxf = _channel_mix(x, lp, cfg, xp_ffn, seq_mode)
    return constrain(x + ffn, "batch", "seq_res", "act_embed"), nxa, nxf, nst


def _stack(params: Tree, x: torch.Tensor, cfg: ModelConfig, cache: Tree,
           seq_mode: bool) -> torch.Tensor:
    """Every layer over x, writing each layer's new state into its views of
    ``cache`` in place; returns the final-normed activations."""
    xp_att, xp_ffn, st = cache["rwkv"]
    for i, lp in enumerate(params["layers"]):
        x, nxa, nxf, nst = _layer(x, lp, cfg, xp_att[i], xp_ffn[i], st[i], seq_mode)
        xp_att[i].copy_(nxa)
        xp_ffn[i].copy_(nxf)
        st[i].copy_(nst)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


# ----------------------------------------------------------------- public API
def prefill(params: Tree, tokens: torch.Tensor, cfg: ModelConfig, *,
            max_len: Optional[int] = None, **_) -> Tuple[torch.Tensor, Tree]:
    """tokens [B,S] -> (last-token logits [B,V] float32, decode state).
    ``max_len`` is checked against the prompt and otherwise ignored, as are
    the transformer's keywords (``dropless``, ``patch_embeds``)."""
    b, s = tokens.shape
    if max_len is not None and s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    cache = zeros(abstract_cache(cfg, b, s), tokens.device, params["embedding"])
    x = _stack(params, L.embed(params["embedding"], tokens), cfg, cache, True)
    return (x[:, -1] @ params["unembed"]).float(), cache


def _train_layer(x, lp, cfg: ModelConfig, x_prev, state):
    return _layer(x, lp, cfg, x_prev, x_prev, state, True)[0]


def loss_fn(params: Tree, batch: Tree, cfg: ModelConfig, **_):
    """batch: tokens [B,S], labels [B,S] -> (ce, {"ce", "aux": 0.0}): every
    layer over the whole sequence from a zero state, each under
    ``torch.utils.checkpoint``."""
    tokens = batch["tokens"]
    b = tokens.shape[0]
    x = constrain(L.embed(params["embedding"], tokens), "batch", "seq_res", "act_embed")
    k = cfg.resolved_head_dim
    dt = str(x.dtype).removeprefix("torch.")
    x_prev = zeros(ParamSpec((b, cfg.d_model), ("batch", "act_embed"), dt, "zeros"), x.device, x)
    state = zeros(ParamSpec((b, cfg.num_heads, k, k), ("batch", "ssm_heads", None, None),
                            "float32", "zeros"), x.device, x)
    for lp in params["layers"]:
        x = checkpoint(_train_layer, x, lp, cfg, x_prev, state, use_reentrant=False)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    ce = L.chunked_cross_entropy(x, params["unembed"], batch["labels"])
    return ce, {"ce": ce, "aux": 0.0}


def decode_step(params: Tree, cache: Tree, tokens: torch.Tensor, cur_index,
                cfg: ModelConfig, **_) -> torch.Tensor:
    """tokens [B] -> logits [B,V] float32; the state in ``cache`` advances
    in place.  ``cur_index`` is ignored, as is ``dropless``."""
    del cur_index
    x = _stack(params, L.embed(params["embedding"], tokens[:, None]), cfg, cache, False)
    return (x[:, 0] @ params["unembed"]).float()

"""Diffusion stage: a DiT (diffusion transformer) over video latent tokens
with text cross-attention and AdaLN timestep conditioning, plus a minimal
DDIM-style sampler.  This is the paper's T_Y >> T_X stage — the one the
NodeManager keeps scaling (Figure 10).

Each self- and cross-attention goes through the flash-attention kernel and
each sampling step's update through the DDIM-step kernel
(``repro_torch.models.layers``); ``diffusion_loss`` is the training
objective, whose gradient runs through the flash backward kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.wan_i2v import WanPipelineConfig
from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec

Tree = Dict[str, Any]


def abstract_params(cfg: WanPipelineConfig, dtype: str = "float32") -> Tree:
    d, f, h, nl = cfg.dit_d_model, cfg.dit_d_ff, cfg.dit_heads, cfg.dit_layers
    hd = d // h
    patch_dim = cfg.patch * cfg.patch * cfg.vae_latent_ch
    return {
        "patch_in": ParamSpec((patch_dim, d), (None, "embed"), dtype),
        "time_mlp1": ParamSpec((256, d), (None, "embed"), dtype),
        "time_mlp2": ParamSpec((d, d), ("embed", "embed"), dtype),
        "text_proj": ParamSpec((cfg.text_d_model, d), (None, "embed"), dtype),
        "final_norm": ParamSpec((d,), ("embed",), dtype, "zeros"),
        "patch_out": ParamSpec((d, patch_dim), ("embed", None), dtype, "small"),
        "layers": {
            "ada": ParamSpec((nl, d, 6 * d), ("layers", "embed", None), dtype, "small"),
            "attn_norm": ParamSpec((nl, d), ("layers", "embed"), dtype, "zeros"),
            "wq": ParamSpec((nl, d, h, hd), ("layers", "embed", "heads", "head_dim"), dtype),
            "wk": ParamSpec((nl, d, h, hd), ("layers", "embed", "kv_heads", "head_dim"), dtype),
            "wv": ParamSpec((nl, d, h, hd), ("layers", "embed", "kv_heads", "head_dim"), dtype),
            "wo": ParamSpec((nl, h, hd, d), ("layers", "heads", "head_dim", "embed"), dtype),
            "x_wq": ParamSpec((nl, d, h, hd), ("layers", "embed", "heads", "head_dim"), dtype),
            "x_wk": ParamSpec((nl, d, h, hd), ("layers", "embed", "kv_heads", "head_dim"), dtype),
            "x_wv": ParamSpec((nl, d, h, hd), ("layers", "embed", "kv_heads", "head_dim"), dtype),
            "x_wo": ParamSpec((nl, h, hd, d), ("layers", "heads", "head_dim", "embed"), dtype),
            "x_norm": ParamSpec((nl, d), ("layers", "embed"), dtype, "zeros"),
            "mlp_norm": ParamSpec((nl, d), ("layers", "embed"), dtype, "zeros"),
            "w1": ParamSpec((nl, d, f), ("layers", "embed", "mlp"), dtype),
            "w2": ParamSpec((nl, f, d), ("layers", "mlp", "embed"), dtype),
        },
    }


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace`` in float32, with its arithmetic: start*(1-s) +
    stop*s for s = i/(num-1), and the end point appended exactly."""
    start, stop = np.float32(start), np.float32(stop)
    if num == 1:
        return np.array([start], np.float32)
    step = np.arange(num - 1, dtype=np.float32) / np.float32(num - 1)
    out = start * (np.float32(1.0) - step) + stop * step
    return np.concatenate([out, [stop]]).astype(np.float32)


def schedule(steps: int) -> Tuple[np.ndarray, np.ndarray]:
    """-> (alphas_cumprod f32 [1000], timesteps int32 [steps]).  Built on the
    host in numpy float32, as the JAX sampler builds it; the timesteps
    truncate the float32 values as ``astype(int32)`` does."""
    betas = _linspace_f32(1e-4, 0.02, 1000)
    alphas = np.cumprod(np.float32(1.0) - betas, dtype=np.float32)
    ts = _linspace_f32(999, 0, steps).astype(np.int32)
    return alphas, ts


def _timestep_embed(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    half = dim // 2
    rate = np.float32(np.log(np.float32(10000.0))) / np.float32(half - 1)
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=t.device)
                      * float(rate))
    ang = t.float()[:, None] * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def patchify(z: torch.Tensor, cfg: WanPipelineConfig) -> torch.Tensor:
    """z: [B,F,h,w,C] -> tokens [B, F*(h/p)*(w/p), p*p*C]."""
    b, f, h, w, c = z.shape
    p = cfg.patch
    z = z.reshape(b, f, h // p, p, w // p, p, c)
    z = z.permute(0, 1, 2, 4, 3, 5, 6)
    return z.reshape(b, f * (h // p) * (w // p), p * p * c)


def unpatchify(tokens: torch.Tensor, cfg: WanPipelineConfig) -> torch.Tensor:
    b = tokens.shape[0]
    p, c = cfg.patch, cfg.vae_latent_ch
    hp = cfg.latent_size // p
    z = tokens.reshape(b, cfg.num_frames, hp, hp, p, p, c)
    z = z.permute(0, 1, 2, 4, 3, 5, 6)
    return z.reshape(b, cfg.num_frames, hp * p, hp * p, c)


def dit_forward(params: Tree, noisy_tokens: torch.Tensor, t: torch.Tensor,
                text_emb: torch.Tensor, cfg: WanPipelineConfig) -> torch.Tensor:
    """Predict noise. noisy_tokens: [B,N,patch_dim]; t: [B]; text: [B,T,Dt]."""
    x = noisy_tokens @ params["patch_in"]
    b, n, d = x.shape
    pos = torch.arange(n, device=x.device)
    cos = L.rope_freqs(pos, d, 10_000.0)[1]
    x = x + cos.repeat_interleave(2, dim=-1)[None, :, :d].to(x.dtype)
    temb = F.silu(_timestep_embed(t) @ params["time_mlp1"]) @ params["time_mlp2"]
    ctx = text_emb @ params["text_proj"]

    for lp in params["layers"]:
        ada = (temb @ lp["ada"]).reshape(b, 6, 1, d)
        sh1, sc1, g1, sh2, sc2, g2 = ada.unbind(1)
        h = L.rms_norm(x, lp["attn_norm"]) * (1 + sc1) + sh1
        att = L.attention_full(L.project_heads(h, lp["wq"]),
                               L.project_heads(h, lp["wk"]),
                               L.project_heads(h, lp["wv"]), causal=False)
        x = x + g1 * L.merge_heads(att, lp["wo"])
        # text cross attention
        hx = L.rms_norm(x, lp["x_norm"])
        attx = L.attention_full(L.project_heads(hx, lp["x_wq"]),
                                L.project_heads(ctx, lp["x_wk"]),
                                L.project_heads(ctx, lp["x_wv"]), causal=False)
        x = x + L.merge_heads(attx, lp["x_wo"])
        h = L.rms_norm(x, lp["mlp_norm"]) * (1 + sc2) + sh2
        x = x + g2 * (F.gelu(h @ lp["w1"], approximate="tanh") @ lp["w2"])
    x = L.rms_norm(x, params["final_norm"])
    return x @ params["patch_out"]


def ddim_sample(params: Tree, z_init_tokens: torch.Tensor,
                text_emb: torch.Tensor, cfg: WanPipelineConfig,
                generators: Optional[Sequence[torch.Generator]] = None,
                n_steps: int = 0,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Deterministic DDIM from pure noise conditioned on (image-latent
    prepended) tokens + text.  Returns denoised latent tokens.  The initial
    noise is drawn per row from ``generators[i]``, or given as ``noise``."""
    steps = n_steps or cfg.diffusion_steps
    alphas, ts = schedule(steps)
    if noise is None:
        noise = torch.stack([
            torch.randn(z_init_tokens.shape[1:], generator=g,
                        dtype=z_init_tokens.dtype, device=z_init_tokens.device)
            for g in generators])
    x = noise
    b = x.shape[0]
    for i in range(steps):
        t = int(ts[i])
        t_prev = int(ts[i + 1]) if i + 1 < steps else 0
        cond = x + z_init_tokens  # image conditioning via additive latent
        eps = dit_forward(params, cond,
                          torch.full((b,), t, dtype=torch.int32, device=x.device),
                          text_emb, cfg)
        x = L.ddim_update(x, eps, alphas[t], alphas[t_prev])
    return x


def diffusion_loss(params: Tree, z_tokens: torch.Tensor, text_emb: torch.Tensor,
                   cfg: WanPipelineConfig, *, t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Noise-prediction MSE: z_tokens [B,N,patch_dim] noised at timesteps
    ``t`` [B] (ints in [0, 1000)) with ``noise``, each given or drawn from
    ``generator`` (the JAX package draws both with ``jax.random``); the DiT
    differentiates through the flash backward kernel on the card."""
    b = z_tokens.shape[0]
    if t is None:
        t = torch.randint(0, 1000, (b,), generator=generator, device=z_tokens.device)
    if noise is None:
        noise = torch.randn(z_tokens.shape, generator=generator, dtype=z_tokens.dtype,
                            device=z_tokens.device)
    alphas, _ = schedule(1)
    a = torch.as_tensor(alphas, device=z_tokens.device)[t.long()][:, None, None]
    noisy = torch.sqrt(a) * z_tokens + torch.sqrt(1 - a) * noise
    pred = dit_forward(params, noisy, t, text_emb, cfg)
    return torch.mean((pred - noise) ** 2)

"""VAE encode/decode stages: convolutional autoencoder on pixel frames, and
``vae_loss``, its training objective.

The public functions keep the JAX package's NHWC layout; the convolutions
run in NCHW with OIHW weights (``repro_torch.convert`` transposes them).
``padding="SAME"`` is reproduced exactly: a stride-2 3x3 conv on an even
size pads (0, 1), not (1, 1).

On the card the convolutions do not go through cuDNN.  cuDNN picks its
algorithm by the memory free at the first call of a shape, and again
whenever the cached one fails to allocate its workspace: at ``PORT``'s
480x480 frames its FFT algorithms ask for tens of GB, so a decode that runs
beside another stage may fall back to another algorithm for the rest of
the process, and the same latents then decode to other frames (the
decoder's tanh saturates at these weights, so a changed sum order flips
pixels between -1 and 1).  ATen's own convolution (im2col and a GEMM)
computes a shape one way whatever the free memory.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.wan_i2v import WanPipelineConfig
from repro_torch.models.param import ParamSpec

Tree = Dict[str, Any]


def _conv_spec(cin: int, cout: int, name_dtype: str) -> ParamSpec:
    return ParamSpec((3, 3, cin, cout), (None, None, None, "conv"), name_dtype)


def abstract_params(cfg: WanPipelineConfig, dtype: str = "float32") -> Tree:
    ch = cfg.vae_base_ch
    enc, dec = {}, {}
    cin = 3
    for i in range(cfg.vae_downs):
        cout = ch * (2 ** i)
        enc[f"down{i}_a"] = _conv_spec(cin, cout, dtype)
        enc[f"down{i}_b"] = _conv_spec(cout, cout, dtype)
        cin = cout
    enc["to_latent"] = _conv_spec(cin, 2 * cfg.vae_latent_ch, dtype)  # mu, logvar
    cin2 = cfg.vae_latent_ch
    for i in reversed(range(cfg.vae_downs)):
        cout = ch * (2 ** i)
        dec[f"up{i}_a"] = _conv_spec(cin2, cout, dtype)
        dec[f"up{i}_b"] = _conv_spec(cout, cout, dtype)
        cin2 = cout
    dec["to_rgb"] = _conv_spec(cin2, 3, dtype)
    return {"encoder": enc, "decoder": dec}


def _same_pad(n: int, stride: int, k: int = 3) -> Tuple[int, int]:
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv2d(x: torch.Tensor, w: torch.Tensor, stride: int,
            padding: Tuple[int, int]) -> torch.Tensor:
    """``F.conv2d`` with cuDNN off for this call alone (module docstring);
    on the CPU it is ``F.conv2d``."""
    return torch.ops.aten._convolution(
        x, w, None, [stride, stride], list(padding), [1, 1], False, [0, 0], 1,
        False, False, False, False)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x [N,C,H,W], w [O,I,3,3]; ``padding="SAME"`` as XLA computes it."""
    ph, pw = _same_pad(x.shape[2], stride), _same_pad(x.shape[3], stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return _conv2d(x, w, stride, (ph[0], pw[0]))
    return _conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride, (0, 0))


def moments(params: Tree, frames: torch.Tensor,
            cfg: WanPipelineConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic encoder pass: frames [B,H,W,3] -> (mu, logvar) NHWC."""
    x = frames.permute(0, 3, 1, 2)
    for i in range(cfg.vae_downs):
        x = F.silu(_conv(x, params["encoder"][f"down{i}_a"], stride=2))
        x = x + F.silu(_conv(x, params["encoder"][f"down{i}_b"]))
    stats = _conv(x, params["encoder"]["to_latent"]).permute(0, 2, 3, 1)
    mu, logvar = stats.chunk(2, dim=-1)
    return mu, logvar.clamp(-10.0, 10.0)


def encode(params: Tree, frames: torch.Tensor, cfg: WanPipelineConfig, *,
           noise: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None):
    """frames [B,H,W,3] -> (latent sample, mu, logvar) [B,h,w,C_lat]: the
    reparameterization noise given as ``noise``, or drawn whole from
    ``generator`` (the JAX package draws it with ``jax.random``)."""
    mu, logvar = moments(params, frames, cfg)
    if noise is None:
        noise = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                            device=mu.device)
    return mu + torch.exp(0.5 * logvar) * noise, mu, logvar


def encode_batched(params: Tree, frames: torch.Tensor, cfg: WanPipelineConfig,
                   generators: Optional[Sequence[torch.Generator]] = None,
                   noise: Optional[torch.Tensor] = None):
    """Microbatched encode: one conv pass over the stacked batch, with the
    reparameterization noise drawn per sample, row i from ``generators[i]``,
    or given as ``noise`` [B,h,w,C] — stacking requests never changes a
    request's latent sample.  -> (z, mu, logvar), NHWC."""
    mu, logvar = moments(params, frames, cfg)
    if noise is None:
        noise = torch.stack([
            torch.randn(mu.shape[1:], generator=g, dtype=mu.dtype,
                        device=mu.device) for g in generators])
    return mu + torch.exp(0.5 * logvar) * noise, mu, logvar


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Element repeat on H, then W (``jnp.repeat``), in NCHW."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def decode(params: Tree, z: torch.Tensor, cfg: WanPipelineConfig) -> torch.Tensor:
    """z: [B,h,w,C_lat] -> frames [B,H,W,3]."""
    x = z.permute(0, 3, 1, 2)
    for i in reversed(range(cfg.vae_downs)):
        x = _upsample2(x)
        x = F.silu(_conv(x, params["decoder"][f"up{i}_a"]))
        x = x + F.silu(_conv(x, params["decoder"][f"up{i}_b"]))
    return torch.tanh(_conv(x, params["decoder"]["to_rgb"])).permute(0, 2, 3, 1)


def vae_loss(params: Tree, frames: torch.Tensor, cfg: WanPipelineConfig, *,
             noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None):
    """Reconstruction + 1e-4 KL of frames [B,H,W,3] -> (loss, {"rec",
    "kl"}); the noise as ``encode`` takes it."""
    z, mu, logvar = encode(params, frames, cfg, noise=noise, generator=generator)
    rec = torch.mean((decode(params, z, cfg) - frames) ** 2)
    kl = -0.5 * torch.mean(1 + logvar - mu ** 2 - torch.exp(logvar))
    return rec + 1e-4 * kl, {"rec": rec, "kl": kl}

"""The paper's own workload: a Wan2.1-style image-to-video AIGC pipeline.

This is the multi-stage workflow the paper evaluates (§2.4): T5&CLIP text
conditioning -> VAE encode -> latent-space diffusion (DiT) -> VAE decode.

Profiles:

* ``SMALL`` — CPU-sized, for the parity tests against the JAX package.
* ``FULL`` — the published widths and depths.
* ``PORT`` — the profile served on one H100: every width of ``FULL``
  (d_model 5120/4096, 40/64 heads, head_dim 128/64, d_ff 13824/10240,
  vocab 32128, text_len 512, 480x480 frames, VAE base 96 channels, 16
  latent channels, 21 frames, so 18,900 video tokens), with only the depth
  cut to 2 text layers, 2 DiT layers and 2 sampling steps.  ``FULL``'s DiT
  alone is 40 x 508.7 M parameters, about 81 GB in float32, more than the
  card's 80 GB; ``PORT`` holds about 1.07 B DiT and 0.43 B text-encoder
  parameters, about 6 GB in float32.  No further cut is made.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class WanPipelineConfig:
    name: str
    # Text encoder (T5-style encoder stack)
    text_layers: int
    text_d_model: int
    text_heads: int
    text_d_ff: int
    text_vocab: int
    text_len: int
    # VAE (conv encoder/decoder on pixel frames)
    image_size: int           # square frames
    vae_base_ch: int
    vae_latent_ch: int
    vae_downs: int            # number of 2x downsampling stages
    # DiT (latent video diffusion transformer)
    dit_layers: int
    dit_d_model: int
    dit_heads: int
    dit_d_ff: int
    num_frames: int
    patch: int                # latent patch size
    diffusion_steps: int

    @property
    def latent_size(self) -> int:
        return self.image_size // (2 ** self.vae_downs)

    @property
    def tokens_per_frame(self) -> int:
        return (self.latent_size // self.patch) ** 2

    @property
    def video_tokens(self) -> int:
        return self.num_frames * self.tokens_per_frame


SMALL = WanPipelineConfig(
    name="wan-i2v-small",
    text_layers=2, text_d_model=128, text_heads=4, text_d_ff=512,
    text_vocab=1024, text_len=32,
    image_size=32, vae_base_ch=16, vae_latent_ch=4, vae_downs=2,
    dit_layers=2, dit_d_model=128, dit_heads=4, dit_d_ff=512,
    num_frames=4, patch=2, diffusion_steps=8,
)

FULL = WanPipelineConfig(
    name="wan-i2v-full",
    text_layers=24, text_d_model=4096, text_heads=64, text_d_ff=10240,
    text_vocab=32_128, text_len=512,
    image_size=480, vae_base_ch=96, vae_latent_ch=16, vae_downs=3,
    dit_layers=40, dit_d_model=5120, dit_heads=40, dit_d_ff=13824,
    num_frames=21, patch=2, diffusion_steps=50,
)

PORT = dataclasses.replace(FULL, name="wan-i2v-port", text_layers=2,
                           dit_layers=2, diffusion_steps=2)

PROFILES = {"small": SMALL, "port": PORT}

"""The Wan2.1-style I2V pipeline wired as OnePiece workflow stages.

``build_stage_fns`` returns the four user-defined stage callables the
cluster layer runs on workflow instances; payloads are numpy pytrees moving
over the RDMA fabric as WorkflowMessages — the dynamic-size, arbitrary-type
case NCCL can't serve (§6 L1/L2).  Each stage moves its inputs onto the
pipeline's device, runs there, and hands its outputs back as numpy.

Every stage is **batch-aware**: the cluster layer's microbatching scheduler
(repro_torch.core.batching) may stack N requests along axis 0 before
invoking a stage, so each fn accepts ``seed`` as a scalar (one request) or a
[N] vector (one per stacked request) and runs one call for the whole batch.
All randomness is drawn per request from its own seed, with a
``torch.Generator`` on the device — request i's output is independent of
who it was batched with.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.wan_i2v import PORT, WanPipelineConfig
from repro_torch.convert import to_port_layout
from repro_torch.device import DeviceLike, generator, resolve_device
from repro_torch.models.aigc import dit as dit_mod
from repro_torch.models.aigc import text_encoder as text_mod
from repro_torch.models.aigc import vae as vae_mod
from repro_torch.models.param import init_tree

#: Per-request random streams: the VAE reparameterization draw and the DDIM
#: initial noise each come from their own generator, seeded 2*seed + stream.
STREAM_VAE, STREAM_DDIM = 0, 1
MODELS = (("text", text_mod), ("vae", vae_mod), ("dit", dit_mod))


def request_seeds(seeds: Any, batch: int) -> List[int]:
    """Per-row seeds from a scalar seed or a [N] seed vector.  A scalar seed
    with batch > 1 (the monolithic baseline path) fans out to seed+i per row
    so samples stay distinct."""
    s = np.asarray(seeds).reshape(-1).astype(np.int64)
    if s.size == 1 and batch > 1:
        s = s[0] + np.arange(batch, dtype=np.int64)
    if s.size != batch:
        raise ValueError(f"{s.size} seeds for batch {batch}")
    return [int(x) for x in s]


def _np(x: torch.Tensor) -> np.ndarray:
    return x.contiguous().cpu().numpy()


@dataclass
class WanI2VPipeline:
    """All four stage models and their entry points (batched over requests).

    ``params`` takes ``{"text", "vae", "dit"}`` trees in the port's layout
    (``repro_torch.convert.params_from_numpy``); when None, the weights are
    drawn from ``seed`` on the device."""

    cfg: WanPipelineConfig = field(default_factory=lambda: PORT)
    seed: int = 0
    device: DeviceLike = None
    params: Optional[Dict[str, Any]] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.params is None:
            g = generator(self.seed, self.device)
            self.params = {
                name: to_port_layout(init_tree(mod.abstract_params(self.cfg),
                                               g, self.device))
                for name, mod in MODELS}
        self.text_params = self.params["text"]
        self.vae_params = self.params["vae"]
        self.dit_params = self.params["dit"]

    def generators(self, seeds: List[int], stream: int) -> List[torch.Generator]:
        return [generator(2 * s + stream, self.device) for s in seeds]

    def tensor(self, x) -> torch.Tensor:
        a = np.asarray(x)
        if not a.flags.writeable:  # payloads decoded off the ring are views
            a = a.copy()
        return torch.as_tensor(a, device=self.device)

    @torch.inference_mode()
    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        return text_mod.encode_text(self.text_params, tokens, self.cfg)

    @torch.inference_mode()
    def vae_encode(self, image: torch.Tensor, seeds: List[int]) -> torch.Tensor:
        """image [B,H,W,3] -> latent sample [B,h,w,C], noise per seed."""
        z, _, _ = vae_mod.encode_batched(
            self.vae_params, image, self.cfg,
            self.generators(seeds, STREAM_VAE))
        return z

    @torch.inference_mode()
    def image_tokens(self, z: torch.Tensor) -> torch.Tensor:
        """latent [B,h,w,C] repeated over the frames -> DiT tokens."""
        b = z.shape[0]
        video = z[:, None].expand(b, self.cfg.num_frames, *z.shape[1:])
        return dit_mod.patchify(video, self.cfg)

    @torch.inference_mode()
    def diffuse(self, z_img_tokens: torch.Tensor, text_emb: torch.Tensor,
                seeds: List[int]) -> torch.Tensor:
        """z_img_tokens [B,T,D]; initial noise per seed."""
        return dit_mod.ddim_sample(self.dit_params, z_img_tokens, text_emb,
                                   self.cfg,
                                   self.generators(seeds, STREAM_DDIM))

    @torch.inference_mode()
    def vae_decode(self, latent_frames: torch.Tensor) -> torch.Tensor:
        b, f = latent_frames.shape[:2]
        flat = latent_frames.reshape((b * f,) + latent_frames.shape[2:])
        frames = vae_mod.decode(self.vae_params, flat, self.cfg)
        return frames.reshape((b, f) + frames.shape[1:])

    # ------------------------------------------------ monolithic reference
    def generate(self, tokens: np.ndarray, image: np.ndarray,
                 seed: int = 0) -> np.ndarray:
        """End-to-end in one process (the paper's monolithic baseline)."""
        seeds = request_seeds(seed, tokens.shape[0])
        temb = self.encode_text(self.tensor(tokens))
        z_img = self.vae_encode(self.tensor(image), seeds)
        lat = self.diffuse(self.image_tokens(z_img), temb, seeds)
        frames = self.vae_decode(dit_mod.unpatchify(lat, self.cfg))
        return _np(frames)


def build_stage_fns(pipe: WanI2VPipeline) -> Dict[str, Callable]:
    """Stage callables for WorkflowInstances.  Payload schema (every array
    may carry N stacked requests along axis 0; ``seed`` is scalar or [N]):
       client -> text_encode: {tokens, image, seed}
       -> vae_encode: {text_emb, image, seed}
       -> diffusion:  {text_emb, z_tokens, seed}
       -> vae_decode: {latents}
       -> database:   frames ndarray
    """
    cfg = pipe.cfg

    def stage_text(p):
        temb = pipe.encode_text(pipe.tensor(p["tokens"]))
        return {"text_emb": _np(temb), "image": p["image"], "seed": p["seed"]}

    def stage_vae_encode(p):
        image = np.asarray(p["image"])
        seeds = request_seeds(p["seed"], image.shape[0])
        z = pipe.vae_encode(pipe.tensor(image), seeds)
        return {"text_emb": p["text_emb"], "z_tokens": _np(pipe.image_tokens(z)),
                "seed": p["seed"]}

    def stage_diffusion(p):
        z_tokens = pipe.tensor(p["z_tokens"])
        seeds = request_seeds(p["seed"], z_tokens.shape[0])
        lat = pipe.diffuse(z_tokens, pipe.tensor(p["text_emb"]), seeds)
        return {"latents": _np(lat)}

    def stage_vae_decode(p):
        latents = dit_mod.unpatchify(pipe.tensor(p["latents"]), cfg)
        return _np(pipe.vae_decode(latents))

    return {
        "text_encode": stage_text,
        "vae_encode": stage_vae_encode,
        "diffusion": stage_diffusion,
        "vae_decode": stage_vae_decode,
    }


#: The paper's real Wan2.1 I2V topology (§2.4): the text encoder and the
#: image/VAE encoder are independent branches off the client request that
#: merge into the DiT.  ``build_dag_stage_fns`` payloads are arranged so the
#: JoinTable's dict-union merge hands ``diffusion`` exactly the payload the
#: linear chain produced — DAG output is bit-identical to the chain.
DAG_DEPS = {
    "text_encode": [],
    "image_encode": [],
    "diffusion": ["text_encode", "image_encode"],
    "vae_decode": ["diffusion"],
}


def build_dag_stage_fns(pipe: WanI2VPipeline) -> Dict[str, Callable]:
    """Stage callables for the branch-parallel Wan I2V DAG.  Payload schema
    (client request is fanned out to both entrance stages):
       client -> text_encode:  {tokens, image, seed} -> {text_emb}
       client -> image_encode: {tokens, image, seed} -> {z_tokens, seed}
       join   -> diffusion:    {text_emb, z_tokens, seed} -> {latents}
              -> vae_decode:   frames ndarray -> database
    The branch stages *wrap* the chain stages (projecting away the keys
    the other branch supplies) rather than reimplementing them."""
    chain = build_stage_fns(pipe)

    def stage_text(p):
        return {"text_emb": chain["text_encode"](p)["text_emb"]}

    def stage_image(p):
        # the chain's vae_encode only threads text_emb through; the join
        # supplies the real one from the text branch
        out = chain["vae_encode"]({**p, "text_emb": None})
        return {"z_tokens": out["z_tokens"], "seed": out["seed"]}

    return {
        "text_encode": stage_text,
        "image_encode": stage_image,
        "diffusion": chain["diffusion"],
        "vae_decode": chain["vae_decode"],
    }


def measure_stage_times(pipe: WanI2VPipeline, batch: int = 1,
                        n_warm: int = 1, n_iter: int = 3) -> Dict[str, float]:
    """Per-stage wall times — feeds Theorem-1 planning.  Each stage ends by
    copying its outputs to the host, so the clock sees the device's work."""
    cfg = pipe.cfg
    tokens = np.zeros((batch, cfg.text_len), np.int32)
    image = np.zeros((batch, cfg.image_size, cfg.image_size, 3), np.float32)
    fns = build_stage_fns(pipe)
    payload: Any = {"tokens": tokens, "image": image, "seed": 0}
    times: Dict[str, float] = {}
    for name in ("text_encode", "vae_encode", "diffusion", "vae_decode"):
        fn = fns[name]
        out = payload
        for _ in range(n_warm):
            out = fn(payload)
        t0 = time.perf_counter()
        for _ in range(n_iter):
            out = fn(payload)
        times[name] = (time.perf_counter() - t0) / max(n_iter, 1)
        payload = out
    return times

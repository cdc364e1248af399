"""Model-level serving engine: prefill, then the decode loop, for the
language models the port carries (the per-stage compute of an LM stage).

``generate`` runs one prefill over the prompt and then the decode steps
back to back on the device; the sampled tokens stay on the card until one
host sync fetches the finished block.  Every path runs MoE layers dropless
(``moe_ffn_dense_fallback``), as the JAX engine does, so that a token's
output never depends on the other tokens of its batch.  The prefill writes
its cache straight into the ``max_len`` decode layout, zeros past the
prompt, which is what the JAX engine's zero pad of the prefill cache gives
(rwkv6's recurrent state has no positions and is the same size at any
``max_len``; zamba2's Mamba2 states neither, beside its shared block's KV
caches).  The encoder-decoder (whisper) prefills over stub frames, zeros
[B, frontend_tokens, d_model] in the model's type unless the caller passes
``frames``, as the JAX engine does; its cache holds each request's cross
K/V, so it has no slot batch (``init_slots`` raises, as the JAX engine's
does) and serves through ``generate``.

RNG contract
------------
Sampling is batch-composition independent: the token of row ``b`` at step
``i`` depends only on ``(seed, b, i)`` and the row's own logits, never on
the other rows of its batch.  JAX's threefry streams cannot be reproduced
without JAX, so the port defines its own contract with that property.  Row
``b`` of a batch with seed ``s`` has the key ``row_key(s, b)``; at step
``i`` its Gumbel noise over the vocabulary is a counter-based hash of
(key, i, vocabulary index), computed on the device with integer tensor
operations (``_uniform``), so it costs no host sync and is the same on
every device.  The token is ``argmax(logits / t + noise)`` at temperature
``t > 0`` (the division by a per-row tensor in every path, so a lockstep
batch and a slot batch round alike) and ``argmax(logits)`` at ``t = 0``,
then clamped to ``vocab_size - 1``.  A slot inserted with ``seed`` draws as
row 0 of that seed.  So ``generate`` (solo or batched),
``generate_reference`` and slot decode give identical tokens.  Greedy
tokens equal the JAX package's; tokens at ``t > 0`` are the port's own.

Disaggregated serving
---------------------
``prefill``/``init_slots``/``insert_slot``/``decode_segment``/
``release_slot`` split generation into the two stages of the ``llm_disagg``
workflow (``serving/disagg.py``): prefill produces a per-request cache whose
batch axis per leaf is ``batch_axes``; decode holds a ``max_slots``-wide
slot cache where requests join and leave at segment boundaries, each slot
with its own position, step, budget, key and temperature on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, generator, resolve_device
from repro_torch.models import encdec, registry
from repro_torch.models.param import tree_leaves, tree_map, zeros

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B1


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # [B, prompt + generated]
    prompt_len: int
    steps: int


def _hash32(x):
    """A 32-bit integer mix (xor-shift, multiply) of a Python int or an
    int64 tensor of values in [0, 2^32); the products stay below 2^63."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def row_key(seed: int, row: int) -> int:
    """The sampling key of row ``row`` of a batch seeded with ``seed``
    (seeds count modulo 2^32)."""
    return _hash32(_hash32(seed) ^ row)


def _uniform(keys: torch.Tensor, steps: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] float32 in (0, 1): uniform noise of each row's (key, step) over
    n vocabulary entries, 24 random bits each."""
    k = _hash32(keys ^ _hash32(steps.long() + _GOLDEN))[:, None]
    v = torch.arange(n, device=keys.device)[None, :]
    h = _hash32(_hash32((v * _GOLDEN + k) & _M32) ^ k)
    return ((h >> 8).float() + 0.5) * 2.0 ** -24


def _noisy_argmax(logits, keys, steps, t):
    gumbel = -torch.log(-torch.log(_uniform(keys, steps, logits.shape[-1])))
    return torch.argmax(logits / t[:, None] + gumbel, dim=-1)


def _sample_rows(logits: torch.Tensor, keys: torch.Tensor, steps: torch.Tensor,
                 temperature) -> torch.Tensor:
    """One token per row of ``logits`` [B, V].  ``temperature`` is a float
    (lockstep generation) or a per-row float32 tensor (slot decode)."""
    greedy = torch.argmax(logits, dim=-1)
    if not isinstance(temperature, torch.Tensor):
        if temperature <= 0:
            return greedy
        t = torch.full((logits.shape[0],), float(temperature),
                       dtype=torch.float32, device=logits.device)
        return _noisy_argmax(logits, keys, steps, t)
    sampled = _noisy_argmax(logits, keys, steps, temperature.clamp(min=1e-6))
    return torch.where(temperature > 0, sampled, greedy)


class ServingEngine:
    """Prefill and decode for one model on one device (``cuda`` unless the
    caller passes ``device="cpu"``).  ``params`` is a tree in the port's
    layout on that device; by default random weights by the JAX init rules,
    drawn from ``seed``."""

    def __init__(self, cfg: ModelConfig, params=None, *, max_len: int = 256,
                 seed: int = 0, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_len = max_len
        registry.abstract_cache(cfg, 1, max_len)   # raises for an unported config
        self.params = params if params is not None else registry.init_params(
            cfg, generator(seed, self.device), self.device)
        # each cache leaf's batch axis, by its logical name (as the JAX
        # engine finds it), so slot insert and KV shipping address any leaf
        self._batch_axes = tree_map(lambda s: s.logical.index("batch"),
                                    registry.abstract_cache(cfg, 1, max_len))

    @property
    def batch_axes(self):
        """Tree (matching the cache tree) of each leaf's batch-axis index."""
        return self._batch_axes

    def _clamp(self, tok: torch.Tensor) -> torch.Tensor:
        return torch.clamp(tok, max=self.cfg.vocab_size - 1).to(torch.int32)

    # ------------------------------------------------- disaggregated stages
    def _frames(self, batch: int, frames=None) -> torch.Tensor:
        """The encoder-decoder's stub frames on the device: ``frames`` if
        given, else zeros [B, frontend_tokens, d_model] in the model's type,
        as the JAX engine feeds them."""
        if frames is not None:
            return torch.as_tensor(frames).to(self.device)
        return torch.zeros((batch, self.cfg.frontend_tokens, self.cfg.d_model),
                           dtype=getattr(torch, self.cfg.dtype), device=self.device)

    def prefill(self, prompts: np.ndarray, patch_embeds=None, frames=None):
        """The prefill stage: [B, P] prompts -> (logits [B, V] float32, cache
        tree in the ``max_len`` decode layout), both on the device.  MoE
        layers run dropless, as the JAX engine runs them, so that each
        token's output depends on it alone.  A VLM may take
        ``patch_embeds`` [B, min(frontend_tokens, P), d_model]; the served
        path passes none, as the JAX engine's passes only tokens.  The
        encoder-decoder takes ``frames`` [B, frontend_tokens, d_model]
        (zeros by default); no other family does."""
        tokens = torch.tensor(np.asarray(prompts, np.int32), device=self.device)
        if patch_embeds is not None:
            patch_embeds = torch.as_tensor(patch_embeds).to(self.device)
        kw = {}
        if self.cfg.family == "audio":
            kw["frames"] = self._frames(tokens.shape[0], frames)
        elif frames is not None:
            raise ValueError(f"{self.cfg.name}: frames need the audio family, not "
                             f"{self.cfg.family!r}")
        return registry.prefill(self.params, tokens, self.cfg, max_len=self.max_len,
                                dropless=True, patch_embeds=patch_embeds, **kw)

    def decode_step(self, cache, tokens: torch.Tensor, cur_index) -> torch.Tensor:
        """One decode step as the engine runs every one (MoE dropless):
        tokens [B] at ``cur_index`` (an int or a [B] tensor) -> logits
        [B, V]; ``cache`` is written in place."""
        return registry.decode_step(self.params, cache, tokens, cur_index, self.cfg,
                                    dropless=True)

    def init_slots(self, max_slots: int) -> Dict[str, Any]:
        """Fresh continuous-batching decode state: a ``max_slots``-wide slot
        cache plus per-slot progress and sampling vectors, all inactive."""
        if self.cfg.family == "audio":
            raise NotImplementedError(
                "continuous batching needs the uniform abstract_cache layout; "
                "the audio enc-dec cache is built per request")
        n, dev = max_slots, self.device
        return {
            "cache": zeros(registry.abstract_cache(self.cfg, n, self.max_len), dev),
            "logits": torch.zeros((n, self.cfg.vocab_padded), device=dev),
            "cur_index": torch.zeros(n, dtype=torch.int32, device=dev),
            "step": torch.zeros(n, dtype=torch.int32, device=dev),
            "remaining": torch.zeros(n, dtype=torch.int32, device=dev),
            "keys": torch.zeros(n, dtype=torch.int64, device=dev),
            "temp": torch.zeros(n, dtype=torch.float32, device=dev),
            "active": torch.zeros(n, dtype=torch.bool, device=dev),
        }

    def insert_slot(self, state, slot: int, cache1, logits1, *, start: int,
                    seed: int, steps: int, temperature: float):
        """Join: land a prefilled request (B=1 cache leaves, tensors or
        numpy arrays, and its last-token logits [V]) in slot ``slot`` at a
        segment boundary; it samples as row 0 of ``seed``."""
        for big, small, ax in zip(tree_leaves(state["cache"]), tree_leaves(cache1),
                                  tree_leaves(self._batch_axes)):
            big.narrow(ax, slot, 1).copy_(torch.as_tensor(small).to(big.dtype))
        state["logits"][slot] = torch.as_tensor(logits1).to(self.device)
        state["cur_index"][slot] = start
        state["step"][slot] = 0
        state["remaining"][slot] = steps
        state["keys"][slot] = row_key(seed, 0)
        state["temp"][slot] = temperature
        state["active"][slot] = True
        return state

    def decode_segment(self, state, k: int):
        """``k`` lockstep decode steps over the slot batch, on the device.
        Slots advance while active with budget left; the rest decode rows
        nobody reads.  Returns (state, tokens [k, N] np.int32, advanced
        [k, N] np.bool_): column s holds the next min(k, remaining) tokens
        of the request in slot s, in the rows where ``advanced`` is set.
        One host sync, at the end."""
        toks, advs = [], []
        logits, cur = state["logits"], state["cur_index"]
        for _ in range(k):
            tok = self._clamp(_sample_rows(logits, state["keys"], state["step"],
                                           state["temp"]))
            adv = state["active"] & (state["remaining"] > 0)
            new = self.decode_step(state["cache"], tok, cur)
            logits = torch.where(adv[:, None], new, logits)
            ai = adv.to(torch.int32)
            cur = cur + ai
            state["step"] = state["step"] + ai
            state["remaining"] = state["remaining"] - ai
            toks.append(tok)
            advs.append(adv)
        state["logits"], state["cur_index"] = logits, cur
        return (state, torch.stack(toks).cpu().numpy(),
                torch.stack(advs).cpu().numpy())

    def release_slot(self, state, slot: int):
        """Leave: free a slot at a segment boundary (its cache row stays as
        garbage until the next insert overwrites it)."""
        state["active"][slot] = False
        state["remaining"][slot] = 0
        return state

    # ------------------------------------------------------ monolithic path
    def generate(self, prompts: np.ndarray, *, steps: int = 16,
                 temperature: float = 0.0, seed: int = 0,
                 patch_embeds=None, frames=None) -> GenerationResult:
        """prompts: [B, P] int32.  One prefill (with a VLM's
        ``patch_embeds`` or the encoder-decoder's ``frames``, if given),
        then ``steps`` decode steps on the device; the only host sync
        fetches the finished block."""
        b, p = prompts.shape
        if p + steps > self.max_len:
            raise ValueError(f"{p} + {steps} tokens exceed max_len {self.max_len}")
        logits, cache = self.prefill(prompts, patch_embeds, frames)
        keys = torch.tensor([row_key(seed, r) for r in range(b)], device=self.device)
        out = []
        for i in range(steps):
            step = torch.full((b,), i, dtype=torch.int32, device=self.device)
            tok = self._clamp(_sample_rows(logits, keys, step, temperature))
            logits = self.decode_step(cache, tok, p + i)
            out.append(tok)
        toks = torch.stack(out, dim=1).cpu().numpy()
        return GenerationResult(np.concatenate([prompts, toks], axis=1), p, steps)

    def widen(self, logits, cache, width: int):
        """Prefill outputs padded with zero rows to ``width`` rows: a slot
        batch's shapes, for measuring whether the batch width changes a
        row's numbers."""
        big = zeros(registry.abstract_cache(self.cfg, width, self.max_len), self.device)
        for dst, src, ax in zip(tree_leaves(big), tree_leaves(cache),
                                tree_leaves(self._batch_axes)):
            dst.narrow(ax, 0, src.shape[ax]).copy_(src)
        wide = torch.zeros((width, logits.shape[1]), device=self.device)
        wide[:logits.shape[0]] = logits
        return wide, big

    def generate_reference(self, prompts: np.ndarray, *, steps: int = 16,
                           temperature: float = 0.0,
                           seed: int = 0) -> GenerationResult:
        """The token-at-a-time loop: the prompt fed one decode step at a
        time, one host sync per generated token.  The parity baseline for
        ``generate``, not a serving path; it shares the RNG contract.  The
        encoder-decoder starts from the cache of its zero frames
        (``encdec.make_decode_cache``: the cross K/V, zero self K/V), the
        other families from zeros."""
        b, p = prompts.shape
        if p + steps > self.max_len:
            raise ValueError(f"{p} + {steps} tokens exceed max_len {self.max_len}")
        if self.cfg.family == "audio":
            cache = encdec.make_decode_cache(self.params, self._frames(b), self.cfg,
                                             self.max_len)
        else:
            cache = zeros(registry.abstract_cache(self.cfg, b, self.max_len),
                          self.device)
        tokens = torch.tensor(np.asarray(prompts, np.int32), device=self.device)
        keys = torch.tensor([row_key(seed, r) for r in range(b)], device=self.device)
        logits = None
        for t in range(p):
            logits = self.decode_step(cache, tokens[:, t], t)
        out = [prompts]
        for i in range(steps):
            step = torch.full((b,), i, dtype=torch.int32, device=self.device)
            cur = self._clamp(_sample_rows(logits, keys, step, temperature))
            out.append(cur.cpu().numpy()[:, None])
            logits = self.decode_step(cache, cur, p + i)
        return GenerationResult(np.concatenate(out, axis=1).astype(np.int32), p, steps)

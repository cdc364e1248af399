"""Uniform model API over every family of the JAX package: dense, moe and
vlm (the transformer), ssm (rwkv6), audio (the encoder-decoder, whisper)
and hybrid (Mamba2 with a shared attention block, zamba2).

  abstract_params(cfg)                      -> ParamSpec tree (JAX layout)
  init_params(cfg, generator, device)       -> the port's tree of tensors
  prefill(params, tokens, cfg, max_len=, dropless=, patch_embeds=, frames=)
                                            -> (logits, cache)
  decode_step(params, cache, tokens, cur_index, cfg, dropless=) -> logits
  loss_fn(params, batch, cfg, dropless=)    -> (loss, {"ce", "aux"})
  abstract_cache(cfg, B, S)                 -> ParamSpec tree
  input_specs(cfg, shape)                   -> ParamSpec tree of a step's inputs
  count_params(cfg), count_active_params(cfg)

``dropless`` and ``patch_embeds`` reach the transformer; the other
families ignore ``dropless``, as the JAX package's do.  ``frames`` (the
stub audio frames [B, frontend_tokens, d_model]) is the encoder-decoder's
and only its.  ``loss_fn``'s batch holds tokens and labels [B,S], and
``patch_embeds`` (vlm) or ``frames`` (audio).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.convert import to_port_layout
from repro_torch.models import encdec, mamba2, rwkv6, transformer
from repro_torch.models.param import ParamSpec, count, init_tree

Tree = Dict[str, Any]

_FAMILY = {"dense": transformer, "moe": transformer, "vlm": transformer,
           "ssm": rwkv6, "audio": encdec, "hybrid": mamba2}


def module_for(cfg: ModelConfig):
    if cfg.family not in _FAMILY:
        raise NotImplementedError(
            f"{cfg.name}: unknown family {cfg.family!r}; the port carries "
            f"{sorted(_FAMILY)}")
    return _FAMILY[cfg.family]


def abstract_params(cfg: ModelConfig) -> Tree:
    return module_for(cfg).abstract_params(cfg)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> Tree:
    """Random weights by the JAX init rules, in the port's layout."""
    return to_port_layout(init_tree(abstract_params(cfg), generator, device))


def loss_fn(params: Tree, batch: Tree, cfg: ModelConfig, **kw):
    return module_for(cfg).loss_fn(params, batch, cfg, **kw)


def prefill(params: Tree, tokens: torch.Tensor, cfg: ModelConfig, **kw):
    return module_for(cfg).prefill(params, tokens, cfg, **kw)


def decode_step(params: Tree, cache: Tree, tokens: torch.Tensor, cur_index,
                cfg: ModelConfig, **kw) -> torch.Tensor:
    return module_for(cfg).decode_step(params, cache, tokens, cur_index, cfg, **kw)


def abstract_cache(cfg: ModelConfig, batch: int, seq_len: int) -> Tree:
    return module_for(cfg).abstract_cache(cfg, batch, seq_len)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Tree:
    """ParamSpec stand-ins of a step's inputs (the dry-run's), as the JAX
    package's: train tokens/labels [B,S], prefill tokens [B,S] (+ a VLM's
    patch embeddings or the audio frames), decode tokens [B] and a scalar
    cur_index."""
    b, s = shape.global_batch, shape.seq_len
    tok = ("batch", "seq")
    specs: Tree = {}
    if shape.mode == "decode":
        specs["tokens"] = ParamSpec((b,), ("batch",), "int32", "zeros")
        specs["cur_index"] = ParamSpec((), (), "int32", "zeros")
        return specs
    specs["tokens"] = ParamSpec((b, s), tok, "int32", "zeros")
    if shape.mode == "train":
        specs["labels"] = ParamSpec((b, s), tok, "int32", "zeros")
    if cfg.family == "vlm":
        p = min(cfg.frontend_tokens, s)
        specs["patch_embeds"] = ParamSpec(
            (b, p, cfg.d_model), ("batch", None, "act_embed"), cfg.dtype, "zeros")
    if cfg.family == "audio":
        specs["frames"] = ParamSpec(
            (b, cfg.frontend_tokens, cfg.d_model), ("batch", None, "act_embed"),
            cfg.dtype, "zeros")
    return specs


def count_params(cfg: ModelConfig) -> int:
    return count(abstract_params(cfg))


def count_active_params(cfg: ModelConfig) -> int:
    """Parameters a token runs through (MoE: top_k of num_experts routed)."""
    tree = abstract_params(cfg)
    total = count(tree)
    if cfg.num_experts == 0:
        return total
    expert = sum(math.prod(tree["layers"][name].shape)
                 for name in ("we_gate", "we_up", "we_down"))
    return int(total - expert * (1.0 - cfg.top_k / cfg.num_experts))

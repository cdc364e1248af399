"""T5&CLIP stage: a bidirectional transformer text encoder (T5-style)."""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.wan_i2v import WanPipelineConfig
from repro_torch.models import layers as L
from repro_torch.models.param import ParamSpec

Tree = Dict[str, Any]


def abstract_params(cfg: WanPipelineConfig, dtype: str = "float32") -> Tree:
    d, f, h = cfg.text_d_model, cfg.text_d_ff, cfg.text_heads
    nl = cfg.text_layers
    hd = d // h
    return {
        "embedding": ParamSpec((cfg.text_vocab, d), ("vocab", "embed"), dtype, "small"),
        "final_norm": ParamSpec((d,), ("embed",), dtype, "zeros"),
        "layers": {
            "attn_norm": ParamSpec((nl, d), ("layers", "embed"), dtype, "zeros"),
            "wq": ParamSpec((nl, d, h, hd), ("layers", "embed", "heads", "head_dim"), dtype),
            "wk": ParamSpec((nl, d, h, hd), ("layers", "embed", "kv_heads", "head_dim"), dtype),
            "wv": ParamSpec((nl, d, h, hd), ("layers", "embed", "kv_heads", "head_dim"), dtype),
            "wo": ParamSpec((nl, h, hd, d), ("layers", "heads", "head_dim", "embed"), dtype),
            "mlp_norm": ParamSpec((nl, d), ("layers", "embed"), dtype, "zeros"),
            "w1": ParamSpec((nl, d, f), ("layers", "embed", "mlp"), dtype),
            "w2": ParamSpec((nl, f, d), ("layers", "mlp", "embed"), dtype),
        },
    }


def encode_text(params: Tree, tokens: torch.Tensor,
                cfg: WanPipelineConfig) -> torch.Tensor:
    """tokens: [B, T] -> conditioning embeddings [B, T, D]."""
    x = params["embedding"][tokens.long()]
    for lp in params["layers"]:
        h = L.rms_norm(x, lp["attn_norm"])
        att = L.attention_full(L.project_heads(h, lp["wq"]),
                               L.project_heads(h, lp["wk"]),
                               L.project_heads(h, lp["wv"]), causal=False)
        x = x + L.merge_heads(att, lp["wo"])
        h = L.rms_norm(x, lp["mlp_norm"])
        x = x + F.gelu(h @ lp["w1"], approximate="tanh") @ lp["w2"]
    return L.rms_norm(x, params["final_norm"])

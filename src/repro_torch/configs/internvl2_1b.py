"""internvl2-1b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821].

The ViT vision encoder and its MLP projector are a stub, as in the JAX
package: ``prefill(..., patch_embeds=)`` takes precomputed patch embeddings
of shape [batch, min(frontend_tokens, prompt), d_model] and pastes them over
the first positions; this config is the language decoder that consumes
them.  Serving passes none, as the JAX package's engine passes only tokens.

24 layers, d_model 896, 14 query heads over 2 kv heads of 64 (groups of 7),
d_ff 4864, vocab 151,655 (padded to 151,808), untied embeddings:
629,910,400 parameters, 1.26 GB in bfloat16, and a KV cache of 512 B per
token and layer in bfloat16.  It fits one 80 GB card at full width and
depth.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151_655,
    frontend_tokens=256,   # ViT patch embeddings per image (stub)
    source="arXiv:2404.16821",
)

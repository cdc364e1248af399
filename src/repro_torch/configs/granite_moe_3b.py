"""granite-moe-3b-a800m [moe] — top-8 routing
[hf:ibm-granite/granite-3.0-1b-a400m-base].

The assignment's config line says "MoE 40e top-8" while its citation note
says "32 experts top-8"; the JAX package follows the explicit config field
(40 experts), and so does the port.

32 layers, d_model 1536, 24 query heads over 8 kv heads of 64 (groups of
3), 40 experts of d_ff 512 (8 a token), no shared expert, vocab 49,155
(padded to 49,408), untied embeddings: 3,375,072,768 parameters, 6.75 GB in
bfloat16, and a KV cache of 2 KiB per token and layer in bfloat16.  It fits
one 80 GB card at full width and depth.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,              # per-expert FFN width
    vocab_size=49_155,
    num_experts=40,
    top_k=8,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)

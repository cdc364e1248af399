"""deepseek-moe-16b [moe] — 2 shared + 64 routed experts, top-6,
fine-grained [arXiv:2401.06066].  Layer 0 is dense (as in the source
architecture).

28 layers: layer 0 a dense SwiGLU of d_ff 11264, layers 1-27 MoE; d_model
2048, 16 query heads over 16 kv heads of 128, 64 routed experts of d_ff
1408 (6 a token) and 2 shared ones, vocab 102,400, untied embeddings:
16,377,694,208 parameters (2.83 B active a token), 32.76 GB in bfloat16,
and a KV cache of 8 KiB per token and layer in bfloat16.  It fits one 80 GB
card at full width and depth.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,              # per routed expert
    vocab_size=102_400,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    first_dense_layers=1,
    dense_ff=11264,         # ~ (top_k + shared) * d_ff
    source="arXiv:2401.06066",
)

"""qwen3-1.7b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-1.7B].

28 layers, d_model 2048, 16 query heads and 8 kv heads of 128, d_ff 6144,
vocab 151,936 (padded to 152,064), tied embeddings: about 1.72 B
parameters, 3.4 GB in bfloat16, and a KV cache of 112 KiB per token in
bfloat16.  It fits one 80 GB card at full width and depth.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-1.7B",
)

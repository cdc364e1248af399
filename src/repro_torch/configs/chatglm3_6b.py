"""chatglm3-6b [dense] — 2d RoPE (rotary over half the head), GQA
[arXiv:2406.12793].

28 layers, d_model 4096, 32 query heads over 2 kv heads of 128 (groups of
16), d_ff 13696, vocab 65,024, untied embeddings: 6,243,454,976 parameters,
12.49 GB in bfloat16, and a KV cache of 1 KiB per token per layer in
bfloat16 (28 KiB per token).  It fits one 80 GB card at full width and
depth.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65_024,
    rope_2d=True,          # rotary applied to half the head dim
    rope_theta=10_000.0,
    source="arXiv:2406.12793",
)

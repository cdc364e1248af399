"""zamba2-1.2b [hybrid] — Mamba2 backbone with one shared attention block
[arXiv:2411.15242].

38 Mamba2 layers, d_model 2048, d_inner 4096 (64 SSM heads of 64, state
64, conv width 4), vocab 32,000, and one transformer block (32 heads of
64, SwiGLU of 8192) whose weights are applied after every 6 Mamba2
layers: 6 applications, then 2 tail layers.  1,170,473,856 parameters,
2.34 GB in bfloat16.  A request's decode state is the conv state (0.96 MB
in bfloat16) and the SSD state (39.85 MB in float32) of every layer, the
same size at any prompt length, beside one KV cache per application of
the shared block, 48 KiB a token in bfloat16 (50.33 MB at 1024 tokens).
It fits one 80 GB card at full width and depth.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,          # Mamba2 layers
    d_model=2048,
    num_heads=32,           # shared attention block heads
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,              # shared block MLP width
    vocab_size=32_000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    hybrid_attn_every=6,
    source="arXiv:2411.15242",
)

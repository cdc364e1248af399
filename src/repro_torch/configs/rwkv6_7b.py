"""rwkv6-7b [ssm] — Finch, data-dependent decay, attention-free [arXiv:2404.05892].

32 layers, d_model 4096, 64 WKV heads of 64, d_ff 14336, vocab 65,536:
7,576,621,056 parameters, 15.15 GB in bfloat16.  Its decode state does not
grow with the prompt: two token-shift leaves [32, B, 4096] in bfloat16 and
the WKV state [32, B, 64, 64, 64] in float32, 34.08 MB per request.  It
fits one 80 GB card at full width and depth.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,          # WKV heads, head_size = 64
    head_dim=64,
    d_ff=14336,
    vocab_size=65_536,
    attention_free=True,
    source="arXiv:2404.05892",
)

"""gemma3-27b [dense] — 5:1 local:global attention, qk_norm
[hf:google/gemma-3-27b-pt].

62 layers, d_model 5376, 32 query heads over 16 kv heads of 128, d_ff
21504, vocab 262,144, untied embeddings: 28,417,621,760 parameters, 56.84 GB
(52.93 GiB) in bfloat16, so it fits one 80 GB card whole.  The layers run
as 10 periods of 5 local layers and 1 global one, then 2 local tail layers.
A local layer attends over a 1024-token sliding window and keeps a ring
cache of min(1024, max_len) slots; a global layer keeps the full cache.
The KV cache is 8 KiB per token per layer in bfloat16: at ``max_len`` 2048
a request holds 10 x 2048 + 52 x 1024 positions, about 604 MB.  An int8
cache is refused (no int8 ring cache).

The widths are Gemma 3 27B's (the JAX package's copy cites
hf:google/gemma-3-1b-pt for them).  The architecture is the JAX package's
dense decoder, which departs from the published model in six places:
embeddings untied (Gemma 3 ties them); a SwiGLU MLP (GeGLU there); no
post-attention and post-MLP norms (Gemma 3 norms both sides); one RoPE
theta of 1e6 on every layer (the local layers use 1e4 there); queries
scaled by 128^-0.5 (query_pre_attn_scalar 168 there); vocab 262,144
(262,208 there).  ``embed_scale`` is the port's field for the sqrt(d_model)
embedding scale that the JAX package keys on the name.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262_144,
    sliding_window=1024,
    local_global_pattern=(5, 1),
    qk_norm=True,
    rope_theta=1_000_000.0,
    embed_scale=True,
    source="hf:google/gemma-3-27b-pt",
)

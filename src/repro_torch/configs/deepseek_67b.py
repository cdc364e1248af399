"""deepseek-67b [dense] — llama-arch [arXiv:2401.02954].

95 layers, d_model 8192, 64 query heads over 8 kv heads of 128 (groups of
8), d_ff 22016, vocab 102,400, untied embeddings: 67,425,001,472
parameters, 134.85 GB in bfloat16, which one 80 GB card cannot hold.  A
layer is 692,076,544 parameters (1.38 GB) and the embeddings with the
unembedding 3.36 GB, so the profile served on one card (``PORT_LAYERS``,
applied by ``launch.serve.llm_config(..., "port")``) keeps every width and
cuts the depth to 38 of the 95 layers: 27,976,638,464 parameters, 52.60 GB
of layers and 55.95 GB in all.  The KV cache is 4 KiB per token and layer
in bfloat16, 152 KiB a token at 38 layers.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102_400,
    rope_theta=10_000.0,
    source="arXiv:2401.02954",
)

#: layers of the profile served on one H100: every width, 38 of 95 layers
PORT_LAYERS = 38

"""whisper-large-v3 [audio] — encoder-decoder, conv frontend stub
[arXiv:2212.04356].

32 encoder and 32 decoder layers, d_model 1280, 20 heads of 64 (no
grouping), d_ff 5120, vocab 51,866 (padded to 51,968), logits through the
embedding's transpose: 1,534,732,800 parameters, 3.07 GB in bfloat16.  The
mel-spectrogram and conv feature extractor is a stub, as in the JAX
package: the encoder takes precomputed frame embeddings [B, 1500, 1280].  Its decode cache is a self
K/V cache of 160 KiB a token in bfloat16 (73.4 MB a request at the
published 448-token decoder context) beside the cross K/V of the 1500
encoder frames, 245.76 MB a request, built per request.  It fits one 80 GB
card at full width and depth.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,          # decoder layers
    encoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51_866,
    cross_attention=True,
    frontend_tokens=1500,   # encoder frames after the (stubbed) conv frontend
    source="arXiv:2212.04356",
)

from repro_torch.kernels.decode_attention.ops import (
    decode_attention,
    decode_attention_cache,
    decode_attention_grouped,
    decode_attention_grouped_lse,
    decode_attention_int8_cache,
    decode_attention_int8_grouped,
    decode_attention_int8_grouped_lse,
    decode_attention_quantized,
)
from repro_torch.kernels.decode_attention.ref import (
    chunk_len,
    decode_chunked_ref,
    decode_int8_lse_ref,
    decode_int8_ref,
    decode_lse_ref,
    decode_ref,
    quantize_kv,
)

__all__ = ["chunk_len", "decode_attention", "decode_attention_cache",
           "decode_attention_grouped", "decode_attention_grouped_lse",
           "decode_attention_int8_cache", "decode_attention_int8_grouped",
           "decode_attention_int8_grouped_lse", "decode_attention_quantized",
           "decode_chunked_ref", "decode_int8_lse_ref", "decode_int8_ref",
           "decode_lse_ref", "decode_ref", "quantize_kv"]

"""Language-model configurations: :class:`ModelConfig` and
:class:`ShapeConfig`, field for field as the JAX package defines them, the
dry-run's input shapes (``SHAPES``, ``supported_shapes``) and the card's
figures for its roofline (:data:`H100`).

Three knobs of the JAX config have no meaning here and are left out:
``use_pallas`` (the port picks a kernel by the tensor's device alone),
``decode_unroll`` (a ``lax.scan`` unroll) and ``attn_causal_skip`` (a
variant of the JAX blockwise attention, which the port runs through the
flash kernel).  The TPU ``HardwareConfig`` stays behind too: no TPU figure
describes the card.

One field is the port's own: ``embed_scale``, which the JAX package derives
from the model's name (``name.startswith("gemma")``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters.  ``family`` selects the model
    implementation: dense | moe | ssm (rwkv6) | hybrid (zamba2) | vlm |
    audio (enc-dec)."""

    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    vocab_size: int
    num_kv_heads: int = 0            # 0 -> = num_heads (MHA)
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- attention features -------------------------------------------------
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_2d: bool = False            # chatglm-style 2d rope (half-dim rotary)
    sliding_window: int = 0          # >0: window size for "local" layers
    local_global_pattern: Tuple[int, int] = (0, 0)  # (n_local, n_global) period
    attention_free: bool = False     # rwkv: no attention at all

    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    first_dense_layers: int = 0      # leading dense layers (deepseek-moe)
    dense_ff: int = 0                # d_ff of those dense layers (0 -> d_ff)
    capacity_factor: float = 1.0

    # --- SSM / hybrid -------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    hybrid_attn_every: int = 0       # shared attn block every N ssm layers

    # --- encoder-decoder / frontend stubs ------------------------------------
    encoder_layers: int = 0
    cross_attention: bool = False
    frontend_tokens: int = 0         # stub embeddings (audio frames / patches)

    # --- misc ----------------------------------------------------------------
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    cache_dtype: str = ""            # "" -> same as dtype (serving knob)
    vocab_round: int = 256
    tie_embeddings: bool = False
    embed_scale: bool = False        # scale embeddings by sqrt(d_model) (gemma)
    fsdp_weight_gather: bool = False # ZeRO-3: gather weights before their products
                                     # instead of reducing the activations
    source: str = ""                 # citation from the assignment pool

    def __post_init__(self):
        # the JAX package asserts the same in its decode step
        # (models/transformer.py: "int8 ring cache not implemented")
        if (self.resolved_cache_dtype == "int8" and self.sliding_window
                and self.local_global_pattern[0]):
            raise ValueError(
                f"{self.name}: an int8 KV cache is refused for sliding-window "
                f"layers (gemma3's local ring caches have no int8 form)")
        # the JAX package's encdec.py and mamba2.py only cast their caches to
        # cache_dtype: neither family has a quantized layout with scales
        if self.resolved_cache_dtype == "int8" and self.family in ("audio", "hybrid"):
            raise ValueError(
                f"{self.name}: an int8 KV cache is refused for the {self.family} "
                f"family (its caches have no int8 layout with scales; they are "
                f"served in {self.dtype})")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def resolved_kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def vocab_padded(self) -> int:
        return _round_up(self.vocab_size, self.vocab_round)

    @property
    def resolved_cache_dtype(self) -> str:
        return self.cache_dtype or self.dtype

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    def param_count(self) -> int:
        from repro_torch.models import registry  # local import: no cycle
        return registry.count_params(self)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=256, <=4 experts, with
        the family and every structural feature kept (GQA ratio, qk_norm,
        sliding pattern, shared experts, hybrid period)."""
        d_model = min(self.d_model, 256)
        head_dim = 32
        if self.family == "ssm":  # rwkv: heads * head_dim must equal d_model
            num_heads = d_model // head_dim
            num_kv = num_heads
        else:
            num_heads = max(2, d_model // 64)
            ratio = max(1, self.num_heads // max(1, self.resolved_kv_heads))
            num_kv = max(1, num_heads // ratio)
        num_experts = min(self.num_experts, 4) if self.num_experts else 0
        return replace(
            self,
            num_layers=2,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512),
            dense_ff=min(self.dense_ff, 512) if self.dense_ff else 0,
            vocab_size=min(self.vocab_size, 1024),
            num_experts=num_experts,
            num_shared_experts=min(self.num_shared_experts, 1),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            encoder_layers=2 if self.encoder_layers else 0,
            frontend_tokens=min(self.frontend_tokens, 16),
            hybrid_attn_every=2 if self.hybrid_attn_every else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            vocab_round=64,
        )


@dataclass(frozen=True)
class ShapeConfig:
    """One input shape: sequence length, global batch and mode."""

    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        if self.mode == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", seq_len=4_096, global_batch=256, mode="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, mode="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, mode="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524_288, global_batch=1, mode="decode"),
}

#: the architectures that take ``long_500k`` (recurrent or windowed state)
LONG_CONTEXT_ARCHS = {"rwkv6-7b", "zamba2-1.2b", "gemma3-27b"}


def supported_shapes(cfg: ModelConfig):
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.name in LONG_CONTEXT_ARCHS:
        names.append("long_500k")
    return names


@dataclass(frozen=True)
class HardwareConfig:
    """One card's figures for the dry-run's roofline: peak dense bfloat16
    rate, memory rate and capacity, and the link a collective crosses."""

    name: str
    peak_flops_bf16: float     # FLOP/s per card, dense
    hbm_bandwidth: float       # B/s per card
    link_bandwidth: float      # B/s per card and direction, the slowest link
    hbm_bytes: float           # capacity per card


#: NVIDIA H100 80GB HBM3 (SXM5), power limit 700.00 W.  Peak dense bfloat16
#: and memory rate from NVIDIA's H100 SXM datasheet; ``hbm_bytes`` is the
#: card's own capacity as ``torch.cuda.get_device_properties(0).total_memory``
#: reads it (``chip_smoke.py`` checks it against that reading).  A mesh axis
#: of 16 spans two 8-card NVLink nodes, so a collective over it crosses the
#: inter-node network: ``link_bandwidth`` is one card's 400 Gb/s InfiniBand
#: NDR port (ConnectX-7), 50 GB/s a direction, not NVLink's 450 GB/s.
H100 = HardwareConfig(
    name="NVIDIA H100 80GB HBM3, 700.00 W",
    peak_flops_bf16=989e12,
    hbm_bandwidth=3.35e12,
    link_bandwidth=50e9,
    hbm_bytes=85_017_493_504,
)

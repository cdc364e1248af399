"""LLM serving on the port: the engine (prefill, decode loop, slots) and the
two-stage disaggregated ``llm_disagg`` Workflow Set."""
from repro_torch.serving.disagg import (
    APP_LLM_DISAGG,
    ContinuousDecoder,
    build_llm_disagg_set,
    make_prefill_fn,
)
from repro_torch.serving.engine import GenerationResult, ServingEngine

__all__ = [
    "APP_LLM_DISAGG",
    "ContinuousDecoder",
    "GenerationResult",
    "ServingEngine",
    "build_llm_disagg_set",
    "make_prefill_fn",
]

"""Dry-run machinery: trace every (arch x shape x mesh) case of the port on
fake tensors over a fake process group (nothing allocated, no kernel
launched), count each chip's flops, bytes, collectives and peak memory
(``launch/hlo_analysis.py``), and derive the three roofline terms against
the card's figures (``configs.H100``).

The JAX package lowers and compiles each case with ``ShapeDtypeStruct``
stand-ins and parses the HLO.  Here a case is the port's own step over
DTensors whose local shards are fake tensors made from the ``ParamSpec``
trees, traced once in eager mode: the trace time stands where the JAX
package reports its lowering and compile times, and AdamW updates the
state in place, so nothing is donated.

NOTE: a case needs the process group in place first, a fake one of the
mesh's size (``repro_torch.launch.dryrun`` sets it up before it imports
this module).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

from repro_torch.configs import H100, ModelConfig, ShapeConfig, get_config, get_shape
from repro_torch.convert import to_port_layout
from repro_torch.models import registry
from repro_torch.models.param import tree_leaves, tree_map, use_partitioner
from repro_torch.sharding.partition import Partitioner
from repro_torch.training.optimizer import adamw_abstract
from repro_torch.training.train_step import make_train_step, trainable

# Per-arch microbatch counts for train_4k (the JAX package's).
TRAIN_MICROBATCHES = {
    "deepseek-67b": 8,
    "gemma3-27b": 8,
    "chatglm3-6b": 2,
    "internvl2-1b": 1,
    "granite-moe-3b-a800m": 2,
    "deepseek-moe-16b": 1,
    "rwkv6-7b": 2,
    "zamba2-1.2b": 2,
    "qwen3-1.7b": 1,
    "whisper-large-v3": 2,
}


# ---------------------------------------------------------------- rule sets
def rules_for(cfg: ModelConfig, shape: ShapeConfig,
              overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    rules: Dict[str, Any] = {}
    if shape.mode == "train":
        # Megatron-style sequence parallelism on the residual stream
        rules["seq_res"] = "model"
    if shape.mode in ("prefill", "decode"):
        if shape.name == "long_500k":
            rules["cache_seq"] = "data"   # context-parallel full-attn caches
        else:
            # shard the cache sequence dim over `model` — works even when
            # kv_heads < model axis (deepseek-67b kv=8, granite kv=8, ...)
            rules["cache_seq"] = "model"
            rules["cache_kv_heads"] = None
    rules.update(overrides or {})
    return rules


# -------------------------------------------------------------- case builder
def _stand_ins(part: Partitioner, specs):
    """A ParamSpec tree -> DTensors whose local shards are uninitialised
    (fake, under the caller's FakeTensorMode)."""
    return tree_map(part.empty, specs)


def build_case(cfg: ModelConfig, shape: ShapeConfig, mesh,
               rule_overrides: Optional[Dict[str, Any]] = None):
    """-> (step fn, its arguments): the step of the shape's mode over
    DTensor stand-ins laid out by ``rules_for``.  Call under a
    FakeTensorMode to allocate nothing."""
    part = Partitioner(mesh, rules_for(cfg, shape, rule_overrides))
    pspecs = registry.abstract_params(cfg)
    batch_specs = registry.input_specs(cfg, shape)
    params = _stand_ins(part, pspecs)

    if shape.mode == "train":
        opt = _stand_ins(part, adamw_abstract(pspecs))._replace(step=0)
        batch = _stand_ins(part, batch_specs)
        step = make_train_step(cfg, microbatches=TRAIN_MICROBATCHES.get(cfg.name, 1))

        def fn(params, opt, batch):
            with use_partitioner(part):
                _, _, m = step(trainable(params), opt, batch)
            return m["loss"]

        return fn, (params, opt, batch)

    extras = {}
    if cfg.family == "vlm":
        extras["patch_embeds"] = "patch_embeds"
    if cfg.family == "audio":
        extras["frames"] = "frames"

    if shape.mode == "prefill":
        batch = _stand_ins(part, batch_specs)

        def fn(params, batch):
            with use_partitioner(part):
                return registry.prefill(to_port_layout(params), batch["tokens"], cfg,
                                        max_len=shape.seq_len,
                                        **{k: batch[v] for k, v in extras.items()})

        return fn, (params, batch)

    # decode: one new token per row at the cache's last position
    cache = _stand_ins(part, registry.abstract_cache(cfg, shape.global_batch, shape.seq_len))
    tokens = part.empty(batch_specs["tokens"])
    cur_index = shape.seq_len - 1

    def fn(params, cache, tokens):
        with use_partitioner(part):
            return registry.decode_step(to_port_layout(params), cache, tokens, cur_index,
                                        cfg)

    return fn, (params, cache, tokens)


# ------------------------------------------------------------------ roofline
def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6*N*D (train) / 2*N*D (inference), N = active params."""
    n = registry.count_active_params(cfg)
    mult = 6.0 if shape.mode == "train" else 2.0
    return mult * n * shape.tokens


def analytic_min_bytes(cfg: ModelConfig, shape: ShapeConfig, n_chips: int) -> float:
    """Structural lower bound on HBM traffic per chip per step: weights/
    optimizer/cache must be touched at least this much.  The traced
    ``bytes_per_chip`` is an upper-bound proxy; the truth lies between."""
    import numpy as _np

    pbytes = 2.0 * registry.count_params(cfg)  # bf16
    cache_specs = (registry.abstract_cache(cfg, shape.global_batch, shape.seq_len)
                   if shape.mode != "train" else {})
    cbytes = sum(
        _np.prod(s.shape) * (2 if s.dtype == "bfloat16" else 4)
        for s in tree_leaves(cache_specs)
    )
    act = 2.0 * shape.tokens * cfg.d_model  # one residual pass, bf16
    if shape.mode == "train":
        # fwd + bwd + remat reads of params, grads write, adamw rw (f32 m,v)
        total = pbytes * 3 + pbytes + 4.0 * registry.count_params(cfg) * 4 + act * 8
    elif shape.mode == "prefill":
        total = pbytes + cbytes + act * 4
    else:  # decode: read all params + read cache + write one slot
        total = pbytes + cbytes + act
    return float(total) / n_chips


def roofline_terms(stats: Dict[str, Any], hw=H100) -> Dict[str, float]:
    """The per-chip counts over the card's rates -> per-chip seconds."""
    compute_s = stats["flops_per_chip"] / hw.peak_flops_bf16
    memory_s = stats["bytes_per_chip"] / hw.hbm_bandwidth
    collective_s = stats["collective_bytes_per_chip"] / hw.link_bandwidth
    dominant = max(
        ("compute", compute_s), ("memory", memory_s), ("collective", collective_s),
        key=lambda kv: kv[1],
    )[0]
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s, "dominant": dominant}


def run_case(arch: str, shape_id: str, *, multi_pod: bool = False,
             rule_overrides: Optional[Dict[str, Any]] = None,
             cfg_overrides: Optional[Dict[str, Any]] = None,
             microbatches: Optional[int] = None,
             hw=H100) -> Dict[str, Any]:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    if microbatches is not None:
        TRAIN_MICROBATCHES[cfg.name] = microbatches
    shape = get_shape(shape_id)
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size()

    t0 = time.time()
    with FakeTensorMode():
        fn, args = build_case(cfg, shape, mesh, rule_overrides)
    ana = analyze(fn, *args)
    t_trace = time.time() - t0

    flops_pc = float(ana["flops"])
    bytes_pc = float(ana["bytes_hbm"])
    peak_bytes = int(ana["peak_bytes"])
    stats = {
        "arch": arch,
        "shape": shape_id,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "trace_s": round(t_trace, 2),
        "n_ops": ana["n_ops"],
        "flops_per_chip": flops_pc,
        "bytes_per_chip": bytes_pc,
        "collective_bytes_per_chip": float(ana["collective_bytes"]),
        "collectives": {
            "bytes_by_kind": ana["collective_bytes_by_kind"],
            "count_by_kind": ana["collective_count_by_kind"],
            "total_bytes": ana["collective_bytes"],
        },
        "memory": {
            "peak_bytes": peak_bytes,
            "hbm_bytes": int(hw.hbm_bytes),
            "fits_hbm": bool(peak_bytes <= hw.hbm_bytes),
        },
        "hardware": hw.name,
        "tokens": shape.tokens,
        "model_flops": model_flops(cfg, shape),
        # the traced flops of all chips (the JAX package's name for its
        # HLO-derived total)
        "hlo_flops_total": flops_pc * n_chips,
        "analytic_min_bytes_per_chip": analytic_min_bytes(cfg, shape, n_chips),
    }
    stats["useful_flops_ratio"] = (
        stats["model_flops"] / stats["hlo_flops_total"]
        if stats["hlo_flops_total"] else 0.0
    )
    stats.update(roofline_terms(stats, hw))
    return stats


def case_list():
    """Every (arch x shape) pair honouring the skip rules."""
    from repro_torch.configs import ARCH_IDS, supported_shapes

    cases = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for s in supported_shapes(cfg):
            cases.append((arch, s))
    return cases

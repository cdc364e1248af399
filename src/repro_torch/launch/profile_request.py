"""Where a request's device time goes, on the card, under ``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_request --profile port
    PYTHONPATH=src python -m repro_torch.launch.profile_request --workflow llm
    PYTHONPATH=src python -m repro_torch.launch.profile_request --workflow llm --llm-arch rwkv6-7b
    PYTHONPATH=src python -m repro_torch.launch.profile_request --workflow llm --llm-arch gemma3-27b --max-len 2048
    PYTHONPATH=src python -m repro_torch.launch.profile_request --workflow llm --llm-arch deepseek-moe-16b
    PYTHONPATH=src python -m repro_torch.launch.profile_request --workflow llm --llm-arch zamba2-1.2b

``--workflow wan`` (the default): one monolithic ``generate`` of the Wan I2V
pipeline at a profile's widths, after the per-stage wall times.
``--workflow llm``: one request (a 256-token prompt, 32 new tokens) served
through the ``llm_disagg`` Workflow Set with ``--llm-arch`` (qwen3-1.7b by
default, or any other arch of ``configs.ARCH_IDS``) at full width in
bfloat16 and the depth served on one card (``launch.serve.llm_config``),
after one warm-up request; each run prints the MB of KV pages (or
recurrent state) it shipped.  For zamba2 it first prints one prefill's wall
time and the share of it in the SSD recurrence (``mamba2._ssd``, the
chunked scan, each call timed between device syncs).

Prints the request's wall time, the device time by kernel (top rows of
``key_averages``), the kernels' summed device time against the wall time
(the device's busy share; overlapping kernels would count twice, and these
eager paths issue work from one stream per thread), and the launch counts
of the port's own kernels.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ARCH_IDS
from repro_torch.configs.wan_i2v import PROFILES
from repro_torch.kernels import (
    ddim_step,
    decode_attention_grouped,
    decode_attention_int8_grouped,
    flash_attention,
    wkv6,
)

KERNELS = (flash_attention, ddim_step, decode_attention_grouped,
           decode_attention_int8_grouped, wkv6)


def wan_request(profile_name: str):
    """-> a function that runs one Wan request, warmed up."""
    from repro_torch.launch.serve import make_request
    from repro_torch.models.aigc import WanI2VPipeline
    from repro_torch.models.aigc.pipeline import measure_stage_times

    pipe = WanI2VPipeline(cfg=PROFILES[profile_name], seed=0)
    times = measure_stage_times(pipe, n_warm=1, n_iter=1)
    print("stage wall (s):", {k: round(v, 4) for k, v in times.items()})
    req = make_request(pipe.cfg, np.random.default_rng(0), 0)
    run = lambda: pipe.generate(req["tokens"], req["image"], seed=0)  # noqa: E731
    run()
    return run


def llm_request(arch: str, cache_dtype: str, max_len: int):
    """-> a function that serves one request of ``arch`` through a fresh
    llm_disagg Workflow Set, warmed up."""
    from repro_torch.launch.serve import llm_config, llm_requests
    from repro_torch.serving import APP_LLM_DISAGG, ServingEngine, build_llm_disagg_set

    engine = ServingEngine(llm_config(arch, "port", cache_dtype),
                           max_len=max_len, seed=0)
    rng = np.random.default_rng(0)
    if engine.cfg.family == "hybrid":
        ssd_share(engine)

    def run():
        req = llm_requests(engine.cfg, rng, [256], 32, [0.0])[0]
        ws, _ = build_llm_disagg_set(engine, max_slots=8, segment_len=8)
        with ws:
            proxy = ws.proxies[0]
            proxy.wait_result(proxy.submit(APP_LLM_DISAGG, req), timeout_s=600)
        print(f"kv pages: {ws.transport_stats().kv_bytes / 1e6:.1f} MB shipped")
    run()
    return run


def ssd_share(engine, prompt_len: int = 256) -> None:
    """One prefill of ``prompt_len`` tokens: its wall time alone, then again
    with every call of the SSD recurrence (``mamba2._ssd``) timed between
    device syncs, and their share of that prefill."""
    from repro_torch.models import mamba2

    prompts = np.random.default_rng(1).integers(
        0, engine.cfg.vocab_size, (1, prompt_len)).astype(np.int32)

    def prefill_s() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.prefill(prompts)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prefill_s()
    alone = prefill_s()
    inner, spent = mamba2._ssd, []

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    mamba2._ssd = timed
    try:
        wall = prefill_s()
    finally:
        mamba2._ssd = inner
    print(f"prefill of {prompt_len} tokens: {alone * 1e3:.1f} ms wall; with the SSD "
          f"scan timed {wall * 1e3:.1f} ms, of which mamba2._ssd {sum(spent) * 1e3:.1f} ms "
          f"in {len(spent)} calls ({100 * sum(spent) / wall:.1f} %)")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workflow", default="wan", choices=["wan", "llm"])
    ap.add_argument("--profile", default="port", choices=sorted(PROFILES),
                    help="--workflow wan: the pipeline profile")
    ap.add_argument("--llm-arch", default="qwen3-1.7b", choices=ARCH_IDS,
                    help="--workflow llm: model config")
    ap.add_argument("--cache-dtype", default="", choices=["", "int8"],
                    help="--workflow llm: KV cache type ('' = bfloat16; "
                         "refused for the attention-free rwkv6 and gemma3)")
    ap.add_argument("--max-len", type=int, default=1024,
                    help="--workflow llm: decode cache length")
    ap.add_argument("--rows", type=int, default=12)
    args = ap.parse_args()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}")
    run = (wan_request(args.profile) if args.workflow == "wan"
           else llm_request(args.llm_arch, args.cache_dtype, args.max_len))
    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"request wall {wall * 1e3:.1f} ms; device busy {busy_us / 1e3:.1f} ms "
          f"({busy_us / 1e4 / wall:.1f} %); launches "
          + " ".join(f"{k.__name__}={k.launches}" for k in KERNELS))
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  kernel")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:args.rows]:
        print(f"{e.self_device_time_total / 1e3:10.2f} "
              f"{100 * e.self_device_time_total / max(busy_us, 1):5.1f}% "
              f"{e.count:6d}  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

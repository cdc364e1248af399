#!/usr/bin/env python3
"""Host-and-device time of single wrapper calls, and qwen3-1.7b's decode
step, with the port of the tree at ROOT, on a machine with a CUDA card.

    python3 scripts/call_ms_parent_change.py ROOT

A served decode or a small training step makes one kernel call a layer or
a few, each as long as the host takes to launch it: a wrapper's dispatch
cost shows in a call's host time, not in the device time ``chip_smoke.py``
reports as ``ms``.  Per case, ``call_ms`` is one call between two CUDA
events after a warm-up (the median and the least of 200), and
``loop_ms`` the host's time per call over 200 calls launched back to back
without a sync (the least of 5 such loops; these kernels take less device
time than that, so the loop measures the wrapper).  The cases are the
smoke's served shapes:

- the float32 flash forward (no gradient) at ``causal_gqa`` [2,300,8,64]
  over 2 kv heads and ``train_100m`` [4,256,8,64] over 4, causal;
- the bfloat16 flash forward at qwen3-1.7b's 512-token prefill;
- the bfloat16 and int8 flash-decode at qwen3-1.7b's served cache
  (q [8,16,128], cache [8,8,1024,128], a vector of indices) and the
  bfloat16 one at whisper-large-v3's cross-attention (q [4,20,64], cache
  [4,20,1500,64]);
- WKV6 at rwkv6-7b's decode step (B 8, T 1, 64 heads of 64), bfloat16.

Then qwen3-1.7b's ``ServingEngine.generate`` at full width in bfloat16 (B 4,
a 4-token prompt, 64 new tokens, five runs after a warm-up), as
``scripts/time_generate.py`` times it.  Every call here uses the wrappers'
public entries, which every tree since the decode slice has, so that a
parent unpacked by ``git archive`` into a git-ignored directory runs it
too.  Host times vary from call to call: compare two trees inside one call,
in turns (parent, change, change, parent).  Prints ROOT and one JSON line.
"""
from __future__ import annotations

import json
import statistics
import sys
import time


def _call_ms(torch, fn, reps: int = 200) -> dict:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    loops = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        loops.append((time.perf_counter() - t0) * 1e3 / reps)
        torch.cuda.synchronize()
    return {"call_ms": round(statistics.median(times), 4), "call_min_ms": round(min(times), 4),
            "loop_ms": round(min(loops), 4)}


def main(root: str) -> None:
    sys.path.insert(0, root + "/src")
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.decode_attention import (
        decode_attention_cache, decode_attention_int8_cache)
    from repro_torch.kernels.rwkv6_wkv import wkv6
    from repro_torch.launch.serve import llm_config
    from repro_torch.serving import ServingEngine

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    out = {}
    with torch.no_grad():
        for name, (b, s, h, kv, d), dtype in (
                ("flash_f32_causal_gqa", (2, 300, 8, 2, 64), torch.float32),
                ("flash_f32_train_100m", (4, 256, 8, 4, 64), torch.float32),
                ("flash_bf16_qwen3_prefill_512", (1, 512, 16, 8, 128), torch.bfloat16)):
            q, k, v = randn(b, s, h, d, dtype=dtype), randn(b, s, kv, d, dtype=dtype), \
                randn(b, s, kv, d, dtype=dtype)
            out[name] = _call_ms(torch, lambda: flash_attention(q, k, v, causal=True))
        for name, (b, h, kv, s, d) in (("decode_bf16_qwen3_served", (8, 16, 8, 1024, 128)),
                                       ("decode_bf16_whisper_cross", (4, 20, 20, 1500, 64))):
            q = randn(b, h, d, dtype=torch.bfloat16)
            kc, vc = (randn(b, kv, s, d, dtype=torch.bfloat16) for _ in range(2))
            cur = torch.randint(0, s, (b,), generator=gen, device=dev, dtype=torch.int32)
            out[name] = _call_ms(torch, lambda: decode_attention_cache(q, kc, vc, cur))
        b, h, kv, s, d = 8, 16, 8, 1024, 128
        q = randn(b, h, d, dtype=torch.bfloat16)
        kq, vq = (torch.randint(-127, 128, (b, kv, s, d), generator=gen, device=dev,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((b, kv, s), generator=gen, device=dev) * 0.02 for _ in range(2))
        cur = torch.randint(0, s, (b,), generator=gen, device=dev, dtype=torch.int32)
        out["decode_int8_qwen3_served"] = _call_ms(
            torch, lambda: decode_attention_int8_cache(q, kq, vq, ks, vs, cur))
        b, t, h, kk = 8, 1, 64, 64
        r, k, v = (randn(b, t, h, kk, dtype=torch.bfloat16) for _ in range(3))
        w = (torch.rand((b, t, h, kk), generator=gen, device=dev) * 0.5 + 0.45).to(torch.bfloat16)
        u, st = randn(h, kk, dtype=torch.bfloat16), randn(b, h, kk, kk)
        out["wkv6_bf16_rwkv6_decode"] = _call_ms(torch, lambda: wkv6(r, k, v, w, u, st))

    cfg = llm_config("qwen3-1.7b", "port")
    engine = ServingEngine(cfg, max_len=448, seed=0)
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, 4)).astype(np.int32)
    engine.generate(prompts, steps=8)
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(prompts, steps=64)   # syncs: tokens to the host
        runs.append((time.perf_counter() - t0) * 1e3 / 64)
    out["qwen3_generate_step_ms"] = round(statistics.median(runs), 3)
    out["qwen3_generate_step_min_ms"] = round(min(runs), 3)
    out["qwen3_generate_step_runs"] = [round(x, 3) for x in runs]
    print(root, json.dumps(out), flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit("usage: call_ms_parent_change.py ROOT")
    main(sys.argv[1])

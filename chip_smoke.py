#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --only decode    # set-up and the decode cases alone
    python3 chip_smoke.py --only wkv6      # set-up and the WKV6 cases alone
    python3 chip_smoke.py --only wkv6_bwd  # set-up and the WKV6 backward's build and cases
    python3 chip_smoke.py --only train     # set-up and the training phase alone
    python3 chip_smoke.py --only sharding  # set-up and the sharding phase alone
    python3 chip_smoke.py --only ssd       # set-up and zamba2's SSD scan alone

Phases, in order; any failure exits non-zero and prints no result:

1. Set-up: float32 matmuls and convolutions in full float32 (TF32 off), the
   kernels built from the sources in this checkout (``nvcc``, ``sm_90a``,
   into ``build/``), and the card's name and power limit from ``nvidia-smi``.
2. Kernels: each hand-written kernel against its plain PyTorch version at
   the shapes its path gives it: flash attention (float32, on the tensor
   cores as 3xTF32: its HGMMA count from the SASS, its registers and spills
   from ptxas) and the DDIM step at the Wan I2V ``PORT`` profile (full
   widths), plus a small causal GQA case, a ragged case and the float32
   ``100m`` training preset's causal GQA shape (B 4, S 256), each float32
   flash case timed beside SDPA, and at ``dit_self`` and ``train_100m`` with
   and without the log-sum-exp store that training asks of it; flash-decode (its TMA bulk copies, UBLKCP,
   from the SASS, its registers and spills from ptxas) over a bfloat16 and
   an int8 cache in both layouts at B 8, KV 8, G 2, D 128, S 32768 with a
   mixed per-row index and a full-cache scalar index, and at the served
   S 1024 with a mixed index; the bfloat16 flash prefill (on the tensor cores: its HGMMA count
   from the SASS, its registers and spills from ptxas) at qwen3-1.7b's heads
   for 512, 2500 and 4096 tokens, a causal GQA batch and a ragged non-causal
   case, each timed beside SDPA, and two cases with V x 2^7 held from
   float64 (`FROM_F64_CASES`); the WKV6
   recurrence in its chunked form (on the tensor cores: its HMMA count from
   the SASS, its registers and spills from ptxas) at rwkv6-7b's heads (a
   served 512-token prompt, a ragged 97, a long batch of 8 x 4096, the
   model's own decays with exact zeros and ones at 512 and a ragged 333
   tokens, and a float32 case at the reduced head size).
   For each: the largest absolute error against the stated
   tolerance, the kernel's time, the plain version's, one PyTorch library
   call's where one computes the same function (each by `device_ms`, the
   device time of 50 launches with the inputs out of the L2, for every
   decode case and wherever one call takes under 0.2 ms, else one call
   between CUDA events; that single call's time is printed as call_ms), and the
   bound: the larger of the bytes this call's data needs over 3.35 TB/s and
   its operations over the peak rate of their type (67 TFLOP/s float32
   outside the tensor cores, 495 TFLOP/s TF32 and 989 TFLOP/s bfloat16 on
   them; H100 SXM data sheet).  The float32 flash kernel's bound counts its
   three TF32 products; the float32 FMA bound is printed beside it.  WKV6's
   counts its chunked form's tensor-core products (3xTF32) and its CUDA-core
   work, with the plain loop's float32 FMA bound and the T/64 dependent
   chunk steps beside it.  chatglm3-6b's heads (groups of 16) and
   gemma3-27b's global layers' in the bfloat16 flash prefill and in
   flash-decode, and gemma3-27b's local-layer ring (1024 slots) through
   flash-decode at the clamped index against the plain ring decode.  The
   heads of internvl2-1b (groups of 7, D 64), granite-moe-3b-a800m (groups
   of 3, D 64), deepseek-moe-16b (groups of 1) and deepseek-67b (64 over 8)
   in the bfloat16 flash prefill at 512 tokens and in flash-decode over
   both served caches.  whisper-large-v3's encoder self-attention (1500
   frames) and cross-attention (64 over 1500) and zamba2-1.2b's shared
   block (512 tokens) in the bfloat16 flash prefill; whisper's cross cache
   (S 1500 at index 1499) and self cache (S 448) and zamba2's served cache
   in flash-decode.  Every flash-decode call held against its plain
   version runs with its partials filled with NaN first, so that a combine
   that read them before the split wrote them would fail.  Last zamba2-1.2b's
   SSD scan (``--only ssd``; plain PyTorch, as the JAX package's is plain
   jnp): its chunked form against the step loop it replaced, at the served
   prefill's shape and with gradients at the training run's (`ssd_phase`),
   each timed beside the loop.
3. The port on small inputs, card against CPU on the same weights: the SMALL
   Wan pipeline's latents and frames (same noise), and the reduced float32
   qwen3, chatglm3 (groups of 16), gemma3 (8 layers, window 16, rings
   wrapped in prefill and in decode), deepseek-moe (a dense layer, then a
   MoE layer), granite-moe (24/8 heads), internvl2 (14/2 heads, patch
   embeddings), whisper (random frames), zamba2 (5 layers, the shared
   block after every 2; a 2-token prompt too) and rwkv6 engines' prefill
   logits and greedy tokens.
4. Serving, the main paths, each with the launch counters set to 0 just
   before and read just after: 2 requests through the Wan chain, 2 through
   the DAG and 2 through the audio-to-video DAG (``a2v``: toy asr and llm
   stages in front of the Wan DAG) Workflow Set at ``PORT``, one instance
   per stage; then qwen3-1.7b and chatglm3-6b at full width and depth in
   bfloat16 through the ``llm_disagg`` Workflow Set, each once with the
   bfloat16 cache (8 requests) and once with the int8 cache (4 requests);
   internvl2-1b the same way (text only, as the JAX engine serves it),
   granite-moe-3b-a800m, deepseek-moe-16b and zamba2-1.2b with the
   bfloat16 cache (8 requests each, MoE layers dropless; zamba2's prompts
   of 64 to 256 tokens); then, with the Wan pipeline and those engines
   freed, rwkv6-7b at full width and depth in bfloat16 through the same
   Workflow Set (8 requests, prompts of 64 to 3000 tokens);
   whisper-large-v3 at full width and depth in bfloat16 through
   ``ServingEngine.generate`` (its cache is built per request: no slot
   batch), batches of 4 at prompts of 4 and 64 tokens, 64 new tokens,
   each row equal to its batch-1 run; last, one at a time with every
   earlier model freed,
   gemma3-27b at full width and depth (8 requests, max_len 2048, rings
   wrapped in prefill and in decode) and deepseek-67b at full width and
   38 of its 95 layers (4 requests).  Each model's batch-1 against
   batch-8 logit difference is printed (zamba2's must be 0).  Every request answered, nothing
   dropped, every join assembled, the counters risen by the expected
   launches, frames equal to ``WanI2VPipeline.generate``, latents equal to
   the pipeline's, and tokens equal to ``ServingEngine.generate``.
5. Training (``--only train`` runs set-up and this phase alone): the flash
   backward kernels' builds (``flash_attention_bwd_bf16.cu`` and, as
   3xTF32, ``flash_attention_bwd.cu``, both on the tensor cores: each
   instantiation's HGMMA count, registers and spills, failing at 0 HGMMA or
   a spill) and the kernels, from the log-sum-exp the forward kernel
   stores, against ``attention_bwd_ref`` at qwen3-1.7b's training shape,
   zamba2-1.2b's shared block, whisper's cross-attention, qwen3-1.7b's heads
   at 4096 causal tokens (in bfloat16, each with its distance and bias from
   the float32 gradient in bfloat16 steps), a float32 band of the Wan DiT,
   the float32 ``100m`` preset's shape and the DiT's whole float32
   self-attention at 2 of its heads, each timed beside the plain version and
   SDPA's backward (``torch.profiler``) with its bound and a call's device
   time by kernel, and the bfloat16 forward at
   qwen3-1.7b's training shape timed with and without its log-sum-exp
   store; one loss and gradient of qwen3-1.7b at full width and 2 layers
   through the flash kernels against the same with the attention's forward
   and backward patched to their plain versions; then qwen3-1.7b at full
   width and depth through ``launch.train`` (8 AdamW steps of 4 x 256
   tokens of a bigram chain over 1,024 of its ids),
   the counters set to 0 just before and read just after: ce finite and
   falling, 56 flash forward and 28 backward launches a step, step time,
   tokens/s and peak memory; two steps under ``torch.profiler``: the device
   time by kind of kernel and the device's busy share; last, the
   launcher's float32 ``100m`` preset (12 layers, heads of 64) for 3 steps,
   the float32 backward's path, its counters read the same way.  Then
   rwkv6: the WKV6 backward kernel's build (``wkv6_bwd.cu``: HMMA count,
   registers and spills of each instantiation, its shared memory and blocks
   an SM, failing at a spill or at a main kernel without HMMA) and the
   kernel, through autograd of ``wkv6``, against ``wkv6_bwd_ref`` at
   rwkv6-7b's training shape, the float32 ``100m`` shape and the WKV6
   forward's ragged, long, model-decay and reduced-head cases, two runs
   equal bit for bit, each timed beside the plain version with its bound;
   after qwen3's, one loss and gradient of rwkv6-7b at full width and 2
   layers with each of the WKV6 forward and backward the kernel or its plain
   version (`plain_wkv6`), and the plain loop with its float32 y moved by
   1e-6 as a yardstick: the backward kernel under the plain forward held to
   the plain loop, both kernels to the plain loop within twice the
   yardstick (`RWKV_GRAD_PAIRS`);
   rwkv6-7b at full width and 16 of its 32 layers through
   ``make_train_step`` (6 AdamW steps of 4 x 256 tokens of the bigram
   chain), and the launcher's float32 ``100m`` rwkv6 for 3 steps, each
   with its counters set to 0 just before and read just after: ce finite
   and falling, 2 forward and 1 backward WKV6 launches a layer and step.
   Then the families that had not trained on the card before: one loss
   and gradient of Wan's ``diffusion_loss`` at ``PORT`` (2 DiT layers at
   every width, float32) through the flash kernels against the same under
   the plain attention (the loss within 1e-5 relative, each leaf within
   1e-4 of its largest element), with the flash backward's share of its
   device time; ``vae_loss`` at ``PORT``'s widths on the card against the
   port on the CPU (2 frames, the same limits); whisper-large-v3 (2 encoder
   and 2 decoder layers, random frames), zamba2-1.2b (6 Mamba2 layers and
   the shared block once), internvl2-1b (2 layers, random patch
   embeddings) and granite-moe-3b-a800m (2 layers, dropless, within twice
   a yardstick: the plain attention's output moved by 1e-6) at full width
   in bfloat16, at qwen3's limits, on the init rule's draws at std 1 /
   sqrt(fan-in); on the rule's own weights every flash call of one kernel
   run within 2^-7 of its largest element from float64, and qwen3's,
   zamba2's and gemma3's at the bfloat16 elementwise limit from float64,
   the kernels' arithmetic emulated beside.  Then the four families at full
   width and depth through ``launch.train`` (4 steps), ce finite and
   falling.  Last chatglm3-6b (2 layers), gemma3-27b (one period of 5
   local and 1 global layer, end to end on the rule's weights, as qwen3),
   deepseek-moe-16b (dense layer 0 and one MoE layer, dropless, within
   twice the routing yardstick) and deepseek-67b (2 layers), each with its
   gradient check, then at the depths of `FAMILY_TRAIN_DEPTHS` (24, 6, 8
   and 5 layers) for 4 AdamW steps through ``make_train_step``.  Each run prints its peak memory beside the
   reckoning of its weights, gradients and float32 moments (12 bytes a
   bfloat16 parameter).  Every training run and gradient check
   holds its flash launches to `train_attention_calls`; the backward cases
   include Wan's text cross-attention (float32, 18,900 over 512) and
   whisper's encoder self-attention (bfloat16, 1500 frames).
6. Sharding (``--only sharding`` runs set-up and this phase alone): the
   production dry-run of qwen3-1.7b at ``train_4k``, ``prefill_32k`` and
   ``decode_32k``, deepseek-moe-16b at ``train_4k``, rwkv6-7b at
   ``long_500k`` and zamba2-1.2b at ``prefill_32k`` (the chunked SSD scan
   over 32,768 positions) on a 16x16 mesh, each in a subprocess on the CPU (fake
   tensors over a fake process group; it exits 0 and launches nothing), and
   on the card's 1x1 mesh (NCCL, world size 1) with DTensor weights, cache
   and inputs: qwen3-1.7b at full width and depth (prefill of 4 prompts of
   512 tokens, 8 decode steps), deepseek-moe-16b at full width and 8 of its
   28 layers through the sharded ``moe_ffn``, rwkv6-7b at full width and
   depth through WKV6 under ``local_map``, and one qwen3-1.7b train step at
   B 4 x S 256, each output (the loss and every parameter after the step)
   equal bit for bit to the unsharded port's, with the flash, flash-decode
   and WKV6 launches of the sharded runs above 0.
7. A ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from functools import partial

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM
F32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12      # H100 SXM, TF32 tensor cores, dense
BF16_FLOPS_PER_S = 989e12      # H100 SXM, bfloat16 tensor cores, dense
INT8_OPS_PER_S = 1979e12       # H100 SXM, int8 tensor cores, dense
#: float32 flash attention, element by element, as the card tests hold it
#: (docs/kernels.md: float32 2e-5): |a - b| <= F32_RTOL |b| + F32_ATOL.  At
#: the DiT's shapes outputs are small (|o| <= 0.05), so an absolute limit of
#: 1e-4 would let a single TF32 product pass.
F32_RTOL = F32_ATOL = 2e-5
#: docs/kernels.md bench tolerance of the DDIM step
DDIM_TOL = 1e-5
#: bfloat16 outputs (the flash prefill, and the decode over the bfloat16 and
#: the int8 cache, both with bfloat16 queries): kernel and plain version
#: compute in float32 and each rounds to bfloat16, so an element differs by
#: at most one bfloat16 step, 2^-7 of its value, where the two float32
#: results straddle a rounding boundary.  Each element is held to
#: |a - b| <= BF16_RTOL |b| + BF16_ATOL; the absolute part covers float32
#: summation order near zero where the terms an element sums are of order 1
#: (|v| ~ 1, the kernel phase's N(0, 1) cases).  Where they are far larger
#: (|v| ~ 150 on the init rule's weights) a cancelling element keeps
#: whatever its terms lose: the flash kernels carry p (forward) and dS
#: (backward's dq and dk) as three bfloat16 terms, float32's 24 bits, since
#: two (16 bits) left qwen3-1.7b's layer outputs up to 2.9 of this limit
#: from float64 (`FROM_F64_CASES`, `init_attention_check`).
BF16_RTOL = 2 ** -7
BF16_ATOL = 1e-5
#: Kernel time on the device (`device_ms`): one
#: pair of CUDA events around DEVICE_N launches, the inputs cycling through
#: copies that hold ROTATION_BYTES, four times the H100's 50 MB L2, so that
#: a launch finds them cold.  Used for every decode case (kernel, plain
#: version and SDPA) and for every other case whose single call takes under
#: DEVICE_TIME_BELOW_MS, where one call between two events mostly times the
#: wrapper on the host.
DEVICE_N = 50
ROTATION_BYTES = 4 * 50 * 2 ** 20
DEVICE_TIME_BELOW_MS = 0.2
#: torch.cuda._sleep's cycles per second: above the H100's 1.98 GHz boost
#: clock, so a sleep lasts at least the time asked
SLEEP_CYCLES_PER_S = 2.0e9
SERVE_FRAME_TOL = 1e-4         # served vs generate: the same ops on one card
SERVE_LATENT_RTOL = 1e-4       # served vs the pipeline, of the largest latent
SMALL_LATENT_RTOL = 1e-4       # card vs CPU, relative to the largest latent
SMALL_FRAME_TOL = 2e-3         # card vs CPU frames (tanh output, |f| <= 1)


def flash_f32_cases(port) -> list:
    """The float32 flash forward's cases: the Wan I2V ``port`` profile's
    attentions (full widths), a small causal GQA case, a ragged case and
    the launcher's float32 ``100m`` preset at the smoke's B 4, S 256:
    (name, (B, Sq, Sk, H, KV, D), causal, repetitions)."""
    t_dim, t_heads = port.text_d_model // port.text_heads, port.text_heads
    d_dim, d_heads = port.dit_d_model // port.dit_heads, port.dit_heads
    n, t_len = port.video_tokens, port.text_len
    return [
        ("text_self", (1, t_len, t_len, t_heads, t_heads, t_dim), False, 10),
        ("dit_self", (1, n, n, d_heads, d_heads, d_dim), False, 3),
        ("dit_cross", (1, n, t_len, d_heads, d_heads, d_dim), False, 5),
        ("causal_gqa", (2, 300, 300, 8, 2, 64), True, 10),
        ("ragged", (1, 1000, 777, 4, 4, 128), False, 10),
        ("train_100m", (4, 256, 256, 8, 4, 64), True, 10),
    ]


#: The float32 forward cases timed with and without the log-sum-exp store
#: that training asks of it (`lse_store_cost`).
F32_LSE_STORE_CASES = ("dit_self", "train_100m")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def cuda_times(torch, fn, reps: int) -> list:
    """Milliseconds of ``reps`` runs of ``fn``, each between two CUDA
    events, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def rotation(tensors) -> list:
    """``tensors`` and clones of them, as many copies as hold ROTATION_BYTES
    together (at most DEVICE_N): `device_ms` cycles through them so that a
    launch finds its inputs out of the L2, as a served call does.  Inputs
    that hold less than ROTATION_BYTES / DEVICE_N stay partly in the L2."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    n = min(DEVICE_N, max(1, -(-ROTATION_BYTES // max(nbytes, 1))))
    return [tuple(tensors)] + [tuple(t.clone() for t in tensors) for _ in range(n - 1)]


def device_ms(torch, fns, n: int = DEVICE_N, reps: int = 3) -> float:
    """Device milliseconds per launch: one pair of CUDA events around ``n``
    launches, cycling through ``fns`` (one callable per copy of the inputs,
    from `rotation`), divided by ``n``; the median of ``reps`` such runs.
    The launches are queued behind a sleeping kernel, so the card runs them
    back to back whatever the host's time to issue each: the events see
    device time, not the wrapper's.  If the sleep ended before the host had
    queued the last launch, the run is repeated with a longer sleep."""
    for f in fns[:2]:
        f()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    sleep_s = 2 * (time.perf_counter() - t0) + 2e-3
    out = []
    while len(out) < reps:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_s * SLEEP_CYCLES_PER_S))
        a.record()
        for i in range(n):
            fns[i % len(fns)]()
        b.record()
        queued = not a.query()
        b.synchronize()
        if queued:
            out.append(a.elapsed_time(b) / n)
        else:
            check(sleep_s < 10, "device_ms: the host cannot queue the launches")
            sleep_s *= 2
    return statistics.median(out)


def kernel_and_plain_ms(torch, kernel, plain, reps: int, force: bool = False):
    """Times of a kernel and of its plain version, taken in turns (kernel,
    plain, plain, kernel) so that drift hits both alike.  ``kernel`` and
    ``plain`` are lists of callables, one per copy of the inputs
    (`rotation`).  -> (ms, plain_ms, call_ms, plain_call_ms): call_ms is the
    median of ``reps`` single calls of the first copy between two CUDA
    events (the wrapper's host time included, the L2 warm); ms is
    `device_ms` where the call takes under DEVICE_TIME_BELOW_MS (or
    ``force``), else call_ms."""
    k = cuda_times(torch, kernel[0], reps)
    p = cuda_times(torch, plain[0], reps)
    p += cuda_times(torch, plain[0], reps)
    k += cuda_times(torch, kernel[0], reps)
    call_ms, plain_call_ms = statistics.median(k), statistics.median(p)
    dev_k = force or call_ms < DEVICE_TIME_BELOW_MS
    dev_p = force or plain_call_ms < DEVICE_TIME_BELOW_MS
    ks = [device_ms(torch, kernel)] if dev_k else [call_ms]
    ps = [device_ms(torch, plain)] if dev_p else [plain_call_ms]
    if dev_p:
        ps.append(device_ms(torch, plain))
    if dev_k:
        ks.append(device_ms(torch, kernel))
    return statistics.mean(ks), statistics.mean(ps), call_ms, plain_call_ms


def library_times(torch, library, reps: int, force: bool = False):
    """(ms, call_ms) of a PyTorch library call, as `kernel_and_plain_ms`
    times a kernel; ``library`` is a list of callables, one per copy.  The
    callers force `device_ms` where the kernel beside it took it."""
    call_ms = statistics.median(cuda_times(torch, library[0], reps))
    if force or call_ms < DEVICE_TIME_BELOW_MS:
        return device_ms(torch, library), call_ms
    return call_ms, call_ms


def limit_errs(out, ref, atol=BF16_ATOL, rtol=BF16_RTOL, floor=None):
    """-> (largest |a - b|, largest |a - b| / (atol + rtol |b| + floor)): the
    elementwise check holds where the second is at most 1.  The default
    limit is the bfloat16 one; ``floor`` (a tensor like ``ref``, or None)
    adds to it element by element (`F32_TERM_STEPS`).  Measured in float64
    where ``ref`` is."""
    wide = ref.element_size() == 8
    a, b = (out.double(), ref) if wide else (out.float(), ref.float())
    d = (a - b).abs()
    den = atol + rtol * b.abs() + (0 if floor is None else floor)
    return float(d.max()), float((d / den).max())


def bound(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main(argv) -> int:
    import torch

    only = argv[1] if len(argv) == 2 and argv[0] == "--only" else None
    if argv and only not in ("decode", "wkv6", "wkv6_bwd", "train", "bf16_numerics",
                             "sharding", "ssd"):
        print("usage: chip_smoke.py [--only decode|wkv6|wkv6_bwd|train|bf16_numerics|"
              "sharding|ssd]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.configs.wan_i2v import PORT, SMALL
    from repro_torch.kernels import _build, ddim_step, flash_attention
    from repro_torch.kernels.ddim_step import ddim_coefs, ddim_step_ref
    from repro_torch.kernels.flash_attention import attention_ref
    from repro_torch.launch.serve import (
        build_a2v_stage_fns, build_set, make_request, ring_bytes_for, serve,
        workflow_spec)
    from repro_torch.models.aigc import WanI2VPipeline, dit, text_encoder, vae
    from repro_torch.models.aigc.pipeline import measure_stage_times, request_seeds

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ------------------------------------------------------------ 1. set-up
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("setup: torch.backends.cuda.matmul.allow_tf32=False "
          "torch.backends.cudnn.allow_tf32=False")
    print(f"setup: python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"setup: built {os.path.relpath(lib_path, ROOT)} in "
          f"{time.perf_counter() - t0:.1f}s")
    for line in (_build.BUILD_DIR / "ptxas.log").read_text().splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    kind = torch.cuda.get_device_name(0)

    # ----------------------------------------------------------- 2. kernels
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    if only == "decode":   # the decode cases alone, e.g. to time two trees in one call
        print(json.dumps({"decode": decode_kernel_phase(torch, F, dev, randn)}))
        return 0
    if only == "wkv6":
        print(json.dumps({"wkv6": wkv6_kernel_phase(torch, dev, randn)}))
        return 0
    if only == "wkv6_bwd":
        print(json.dumps({"wkv6_bwd": dict(build=wkv6_bwd_build_report(lib_path),
                                           rows=wkv6_bwd_kernel_phase(torch, dev))}))
        return 0
    if only == "train":
        print(json.dumps({"train": train_phase(torch, F, np, dev, randn, lib_path)},
                         default=str))
        return 0
    if only == "sharding":
        print(json.dumps({"sharding": sharding_phase(torch)}, default=str))
        return 0
    if only == "ssd":
        print(json.dumps({"ssd": ssd_phase(torch, dev)}))
        return 0
    if only == "bf16_numerics":
        print(json.dumps({"bf16_numerics": bf16_numerics(torch, F, dev, randn, lib_path)},
                         default=str))
        return 0

    n = PORT.video_tokens
    flash_hgmma = flash_build_report(lib_path, "flash_fwd_f32")
    flash_rows = []
    for name, (b, sq, sk, h, kv, d), causal, reps in flash_f32_cases(PORT):
        q, k, v = randn(b, sq, h, d), randn(b, sk, kv, d), randn(b, sk, kv, d)
        out = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err, use = limit_errs(out, attention_ref(q, k, v, causal=causal),
                              F32_ATOL, F32_RTOL)
        del out
        sets = rotation((q, k, v))
        ms, plain_ms, call_ms, plain_call_ms = kernel_and_plain_ms(
            torch, [lambda c=c: flash_attention(*c, causal=causal) for c in sets],
            [lambda c=c: attention_ref(*c, causal=causal) for c in sets], reps)
        backends = [SDPBackend.EFFICIENT_ATTENTION]
        if b * h * sq * sk * 4 < (1 << 32):
            backends.append(SDPBackend.MATH)

        def library(qc, kc, vc):
            with sdpa_kernel(backends):
                return F.scaled_dot_product_attention(
                    qc.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
                    is_causal=causal, enable_gqa=h != kv)
        library_ms, library_call_ms = library_times(
            torch, [lambda c=c: library(*c) for c in sets], reps,
            force=call_ms < DEVICE_TIME_BELOW_MS)
        pairs = sq * (sq + 1) // 2 if causal else sq * sk
        nbytes = 4 * (2 * b * sq * h * d + 2 * b * sk * kv * d)
        flops = 4.0 * b * h * pairs * d
        bound_ms, bound_by = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
        fma_bound_ms, _ = bound(nbytes, flops)
        row = dict(shape=name, q=[b, sq, h, d], kv=[b, sk, kv, d], causal=causal,
                   max_abs_err=err, f32_limit_use=use, ms=ms, plain_ms=plain_ms,
                   call_ms=call_ms, plain_call_ms=plain_call_ms,
                   bound_ms=bound_ms, bound_by=bound_by, fma_bound_ms=fma_bound_ms,
                   library_ms=library_ms, library_call_ms=library_call_ms,
                   vs_library=ms / library_ms, bound_share=bound_ms / ms)
        flash_rows.append(row)
        print(f"flash {name:10s} q={row['q']} kv={row['kv']} causal={causal}: "
              f"max_err={err:.3g} ({use:.3f} of the f32 limit) ms={ms:.4f} "
              f"call_ms={call_ms:.4f} "
              f"plain_ms={plain_ms:.4f} sdpa_ms={library_ms:.4f} "
              f"(kernel/sdpa {ms / library_ms:.2f}x) bound_ms={bound_ms:.4f} "
              f"(3xTF32 {bound_by}; {bound_ms / ms:.1%} of it) "
              f"fma_bound_ms={fma_bound_ms:.4f}")
        check(use <= 1.0, f"flash {name}: max_err {err}, {use} of the f32 limit "
                          f"|a-b| <= {F32_RTOL} |b| + {F32_ATOL}")
        if name in F32_LSE_STORE_CASES:
            row["lse_store"] = c = lse_store_cost(torch, q, k, v, causal)
            print(f"flash fwd {name} f32 causal={causal}: without the log-sum-exp store "
                  f"ms={c['ms_without']:.4f}, with it ms={c['ms_with']:.4f} "
                  f"({c['cost']:+.1%}; {c['timed_by']}); o equal bit for bit, lse "
                  f"{c['lse_limit_use']:.3f} of its limit 2e-5 (1 + |b|)")
        del q, k, v, sets

    pd = PORT.patch ** 2 * PORT.vae_latent_ch
    x, eps = randn(1, n, pd), randn(1, n, pd)
    alphas, ts = dit.schedule(PORT.diffusion_steps)
    a_t, a_p = alphas[ts[0]], alphas[ts[1]]
    c1, c2 = ddim_coefs(a_t, a_p)
    out = ddim_step(x, eps, a_t, a_p)
    torch.cuda.synchronize()
    ddim_err = float((out - ddim_step_ref(x, eps, c1, c2)).abs().max())
    sets = rotation((x, eps))
    ddim_ms, ddim_plain_ms, ddim_call_ms, _ = kernel_and_plain_ms(
        torch, [lambda c=c: ddim_step(*c, a_t, a_p) for c in sets],
        [lambda c=c: ddim_step_ref(*c, c1, c2) for c in sets], 25)
    ddim_bound_ms, ddim_bound_by = bound(3 * 4 * x.numel(), 3 * x.numel())
    print(f"ddim  latent     x={list(x.shape)}: max_err={ddim_err:.3g} "
          f"(tol {DDIM_TOL}) ms={ddim_ms:.5f} call_ms={ddim_call_ms:.5f} "
          f"plain_ms={ddim_plain_ms:.5f} "
          f"library_ms=null bound_ms={ddim_bound_ms:.5f} ({ddim_bound_by})")
    check(ddim_err <= DDIM_TOL, f"ddim: max_err {ddim_err} > {DDIM_TOL}")
    del x, eps, out, sets

    ublkcp = decode_build_report(lib_path)
    decode_rows = decode_kernel_phase(torch, F, dev, randn)
    hgmma = flash_build_report(lib_path, "flash_fwd_bf16")
    flash_bf16_rows = flash_bf16_phase(torch, F, dev, randn)
    wkv_hmma = wkv6_build_report(lib_path)
    wkv_rows = wkv6_kernel_phase(torch, dev, randn)
    ssd_rows = ssd_phase(torch, dev)

    # --------------------------------------------- 3. small input, card vs CPU
    small = WanI2VPipeline(cfg=SMALL, seed=0, device="cpu")
    small_gpu = WanI2VPipeline(cfg=SMALL, device=dev, params={
        k: _to(torch, v, dev) for k, v in small.params.items()})
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, SMALL.text_vocab, (2, SMALL.text_len)).astype(np.int32)
    image = (rng.standard_normal((2, SMALL.image_size, SMALL.image_size, 3))
             * 0.1).astype(np.float32)
    hl = SMALL.latent_size
    vae_noise = rng.standard_normal((2, hl, hl, SMALL.vae_latent_ch)).astype(np.float32)
    ddim_noise = rng.standard_normal(
        (2, SMALL.video_tokens, SMALL.patch ** 2 * SMALL.vae_latent_ch)).astype(np.float32)

    def small_run(p):
        with torch.inference_mode():
            temb = text_encoder.encode_text(p.text_params, p.tensor(tokens), SMALL)
            z, _, _ = vae.encode_batched(p.vae_params, p.tensor(image), SMALL,
                                         noise=p.tensor(vae_noise))
            lat = dit.ddim_sample(p.dit_params, p.image_tokens(z), temb, SMALL,
                                  noise=p.tensor(ddim_noise))
            frames = vae.decode(p.vae_params, dit.unpatchify(lat, SMALL)[0], SMALL)
        return lat.cpu().numpy(), frames.cpu().numpy()

    launches = (flash_attention.launches, ddim_step.launches)
    lat_gpu, frames_gpu = small_run(small_gpu)
    check(flash_attention.launches > launches[0] and ddim_step.launches > launches[1],
          "the SMALL run on the card did not launch the kernels")
    lat_cpu, frames_cpu = small_run(small)
    lat_err = float(np.abs(lat_gpu - lat_cpu).max() / np.abs(lat_cpu).max())
    frame_err = float(np.abs(frames_gpu - frames_cpu).max())
    print(f"small: latents card vs cpu max_err/max|x|={lat_err:.3g} "
          f"(tol {SMALL_LATENT_RTOL}), frames max_err={frame_err:.3g} "
          f"(tol {SMALL_FRAME_TOL})")
    check(np.isfinite(frames_gpu).all(), "small: non-finite frames")
    check(lat_err <= SMALL_LATENT_RTOL, "small: latents differ from the CPU path")
    check(frame_err <= SMALL_FRAME_TOL, "small: frames differ from the CPU path")
    del small, small_gpu
    llm_small_phase(torch, np, dev)
    rwkv_small_phase(torch, np, dev)

    # ------------------------------------------------------------- 4. serve
    t0 = time.perf_counter()
    pipe = WanI2VPipeline(cfg=PORT, seed=0)
    torch.cuda.synchronize()
    print(f"serve: PORT pipeline on {pipe.device} in {time.perf_counter() - t0:.1f}s "
          f"({sum(p.numel() for m in pipe.params.values() for p in _leaves(m)) / 1e9:.2f} B "
          f"params); inbox rings {ring_bytes_for(PORT) / 1e6:.1f} MB")
    times = measure_stage_times(pipe, n_warm=0, n_iter=1)
    print("serve: stage times (s):", {k: round(v, 3) for k, v in times.items()})
    per_req_flash = PORT.text_layers + 2 * PORT.dit_layers * PORT.diffusion_steps
    per_req_ddim = PORT.diffusion_steps
    rng = np.random.default_rng(0)
    served_launches = {"flash_attention": 0, "ddim_step": 0}
    served_latents = {}
    runs = {}
    for workflow in ("chain", "dag", "a2v"):
        spec, wtimes = workflow_spec(workflow, pipe, times=times)
        # record the diffusion stage's output (pre-decode latents) per seed:
        # the frames saturate the decoder's tanh at these random weights
        for st in spec.stages:
            if st.name == "diffusion":
                st.fn = _tap(st.fn, workflow, served_latents, request_seeds)
        # admission control is not under test here: admit both at once
        ws = build_set(spec, counts={s: 1 for s in wtimes}, admit_rate=100.0,
                       cfg=PORT, name=workflow, elastic=False)
        reqs = [make_request(PORT, rng, i, workflow) for i in range(2)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        ddim_step.launches = 0
        outs, lost, wall = serve(ws, reqs, timeout_s=900)
        fl, dd = flash_attention.launches, ddim_step.launches
        stats = ws.transport_stats()
        peak = torch.cuda.max_memory_allocated()
        served_launches["flash_attention"] += fl
        served_launches["ddim_step"] += dd
        print(f"serve {workflow}: {len(outs)}/{len(reqs)} answered, lost={lost}, "
              f"dropped={stats.dropped}, {wall:.2f}s wall, "
              f"{len(outs) / wall:.3f} req/s, launches flash={fl} ddim={dd} "
              f"(expected {per_req_flash}/{per_req_ddim} per request), "
              f"max_memory_allocated={peak / 2**30:.2f} GiB")
        check(lost == 0 and len(outs) == len(reqs), f"{workflow}: requests lost")
        check(stats.dropped == 0, f"{workflow}: {stats.dropped} messages dropped")
        if workflow != "chain":
            js = ws.joins.stats
            print(f"serve {workflow}: joins completed={js.completed} "
                  f"aborted={js.aborted_joins} pending={ws.joins.pending_joins()}")
            check(js.completed == len(reqs) and ws.joins.pending_joins() == 0,
                  f"{workflow}: joins {js.completed} completed, "
                  f"{ws.joins.pending_joins()} pending")
        check(fl == per_req_flash * len(reqs), f"{workflow}: flash launches {fl}")
        check(dd == per_req_ddim * len(reqs), f"{workflow}: ddim launches {dd}")
        shape = (1, PORT.num_frames, PORT.image_size, PORT.image_size, 3)
        for o in outs:
            check(o.shape == shape and np.isfinite(o).all(),
                  f"{workflow}: frames {o.shape} not finite of shape {shape}")
        runs[workflow] = (reqs, outs)
    req, served = runs["chain"][0][0], runs["chain"][1][0]
    flash_attention.launches = 0
    ddim_step.launches = 0
    gold = pipe.generate(req["tokens"], req["image"], seed=req["seed"])
    gen_launches = (flash_attention.launches, ddim_step.launches)
    serve_err = float(np.abs(served - gold).max())
    unsaturated = float((np.abs(gold) < 0.99).mean())
    print(f"serve: chain request 0 vs generate max_err={serve_err:.3g} "
          f"(tol {SERVE_FRAME_TOL}); generate launches flash={gen_launches[0]} "
          f"ddim={gen_launches[1]}; frames mean|f|={float(np.abs(gold).mean()):.4f}, "
          f"share with |f|<0.99: {unsaturated:.4f}")
    check(serve_err <= SERVE_FRAME_TOL, "served frames differ from generate")
    check(gen_launches == (per_req_flash, per_req_ddim), "generate launches")
    toy = build_a2v_stage_fns(pipe)
    for workflow, (reqs, _) in runs.items():
        for i, req in enumerate(reqs):
            seeds = [req["seed"]]
            # a2v: the tokens its toy asr and llm stages make of the audio
            tokens = (toy["llm"](toy["asr"](req))["tokens"] if workflow == "a2v"
                      else req["tokens"])
            temb = pipe.encode_text(pipe.tensor(tokens))
            z = pipe.vae_encode(pipe.tensor(req["image"]), seeds)
            lat = pipe.diffuse(pipe.image_tokens(z), temb, seeds).cpu().numpy()[0]
            lat_err = float(np.abs(served_latents[(workflow, req["seed"])] - lat).max())
            tol = SERVE_LATENT_RTOL * float(np.abs(lat).max())
            print(f"serve: {workflow} request {i} latents vs the pipeline's "
                  f"max_err={lat_err:.3g} (tol {SERVE_LATENT_RTOL} x max|x| = "
                  f"{tol:.3g})")
            check(lat_err <= tol, f"{workflow}: request {i}'s served latents differ")

    del pipe, spec, ws, st, toy   # the stage fns hold the pipeline's 6 GB of weights
    torch.cuda.empty_cache()
    by_arch = {}
    for arch in ("qwen3-1.7b", "chatglm3-6b", "internvl2-1b", "granite-moe-3b-a800m",
                 "deepseek-moe-16b", "zamba2-1.2b"):
        by_arch[arch] = llm_serving_phase(torch, np, dev, arch)
        gc.collect()          # the engines and their Workflow Sets
        torch.cuda.empty_cache()
    rwkv_launches = rwkv_serving_phase(torch, np, dev)
    gc.collect()
    torch.cuda.empty_cache()
    by_arch["whisper-large-v3"] = whisper_generate_phase(torch, np, dev)
    gc.collect()
    torch.cuda.empty_cache()
    # last, one at a time: gemma3-27b's 52.93 GiB of weights and deepseek-67b's
    # 52.11 GiB at 38 layers each need every earlier model freed
    for arch in ("gemma3-27b", "deepseek-67b"):
        by_arch[arch] = llm_serving_phase(torch, np, dev, arch)
        gc.collect()
        torch.cuda.empty_cache()
    train = train_phase(torch, F, np, dev, randn, lib_path)
    bf16_runs = {"qwen3-1.7b": train["run"]}
    bf16_runs.update({arch: train[f"{label}_run"]
                      for label, (arch, _) in FAMILY_GRAD_CHECKS.items()})
    for arch, run in bf16_runs.items():
        by_arch[f"train {arch}"] = {"flash_attention": run["flash_launches"]}
    llm = {k: sum(c.get(k, 0) for c in by_arch.values())
           for k in ("flash_attention", "decode_attention_grouped",
                     "decode_attention_int8_grouped")}
    gc.collect()
    torch.cuda.empty_cache()
    shard = sharding_phase(torch)
    sharded = shard["sharded_launches"]

    # ------------------------------------------------------------ 5. result
    dom = next(r for r in flash_rows if r["shape"] == "dit_self")
    kernels = [
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:36",
             launches=served_launches["flash_attention"],
             max_abs_err=max(r["max_abs_err"] for r in flash_rows),
             ms=dom["ms"], plain_ms=dom["plain_ms"], bound_ms=dom["bound_ms"],
             bound_by=dom["bound_by"], library_ms=dom["library_ms"],
             fma_bound_ms=dom["fma_bound_ms"], at="dit_self", hgmma=flash_hgmma,
             shapes=flash_rows),
        dict(name="ddim_step", route="cuda",
             source="src/repro_torch/kernels/ddim_step/csrc/ddim_step.cu",
             replaces="src/repro/kernels/ddim_step/kernel.py:33",
             launches=served_launches["ddim_step"], max_abs_err=ddim_err,
             ms=ddim_ms, call_ms=ddim_call_ms, plain_ms=ddim_plain_ms,
             bound_ms=ddim_bound_ms,
             bound_by=ddim_bound_by, library_ms=None, at="latent [1,18900,64]"),
    ]
    fb = next(r for r in flash_bf16_rows if r["shape"] == "qwen3_prefill_512")
    kernels.append(dict(
        name="flash_attention_bf16", route="cuda",
        source="src/repro_torch/kernels/flash_attention/csrc/flash_attention_bf16.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:36",
        launches=llm["flash_attention"],
        launches_by_model={a: c.get("flash_attention", 0) for a, c in by_arch.items()},
        sharded_launches=sharded["flash_attention"] + sharded["train_flash_attention"],
        max_abs_err=max(r["max_abs_err"] for r in flash_bf16_rows),
        ms=fb["ms"], plain_ms=fb["plain_ms"], bound_ms=fb["bound_ms"],
        bound_by=fb["bound_by"], library_ms=fb["library_ms"],
        at="qwen3_prefill_512", hgmma=hgmma, shapes=flash_bf16_rows))
    for name, cache_kind, counter, replaces in (
            ("decode_attention", "fp", "decode_attention_grouped",
             "src/repro/kernels/decode_attention/kernel.py:64"),
            ("decode_attention_int8", "int8", "decode_attention_int8_grouped",
             "src/repro/kernels/decode_attention/kernel.py:91")):
        rows = [r for r in decode_rows if r["kind"] == cache_kind]
        main = next(r for r in rows if r["shape"] == f"{cache_kind}_cache_vector")
        kernels.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu",
            replaces=replaces, launches=llm[counter],
            launches_by_model={a: c.get(counter, 0) for a, c in by_arch.items()},
            sharded_launches=sharded.get(counter, 0),
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main["ms"], call_ms=main["call_ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], at=main["shape"], ublkcp=ublkcp,
            shapes=rows))
    served = next(r for r in wkv_rows if r["shape"] == "served_512")
    kernels.append(dict(
        name="wkv6", route="cuda",
        source="src/repro_torch/kernels/rwkv6_wkv/csrc/wkv6.cu",
        replaces="src/repro/kernels/rwkv6_wkv/kernel.py:23",
        launches=rwkv_launches, sharded_launches=sharded["wkv6"],
        max_abs_err=max(r["max_abs_err"] for r in wkv_rows),
        ms=served["ms"], plain_ms=served["plain_ms"], bound_ms=served["bound_ms"],
        bound_by=served["bound_by"], library_ms=None, at="served_512",
        fma_bound_ms=served["fma_bound_ms"], hmma=wkv_hmma, shapes=wkv_rows))
    # no TPU kernel behind either backward: the gradient the JAX package
    # takes by autodiff of its plain attention, which it trains with
    bf16_rows = [r for r in train["rows"] if r["dtype"] == "bfloat16"]
    f32_rows = [r for r in train["rows"] if r["dtype"] == "float32"]
    # launches, train and grad_check: qwen3-1.7b's (the float32 100m preset's),
    # as before; the families trained since stand beside them by model
    for name, src, dt, rows, at, runs, checks in (
            ("flash_attention_backward_bf16", "flash_attention_bwd_bf16.cu", "bf16", bf16_rows,
             "qwen3_train_4x256", bf16_runs,
             {"qwen3-1.7b": train["grad_check"],
              **{arch: train[f"{k}_grad_check"] for k, (arch, _) in FAMILY_GRAD_CHECKS.items()}}),
            ("flash_attention_backward", "flash_attention_bwd.cu", "f32", f32_rows,
             "qwen3_100m_4x256", {"qwen3-1.7b 100m": train["run_f32"]},
             {"wan PORT": train["wan_grad_check"]})):
        main = next(r for r in rows if r["shape"] == at)
        run = next(iter(runs.values()))
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/flash_attention/csrc/{src}",
            replaces="src/repro/models/layers.py:136", tpu_kernel=None,
            launches=run["flash_bwd_launches"],
            launches_by_model={a: r["flash_bwd_launches"] for a, r in runs.items()},
            **({"sharded_launches": sharded["train_flash_attention_backward"]}
               if dt == "bf16" else {}),
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=main["library_ms"], at=at,
            fma_bound_ms=main["fma_bound_ms"], build=train["build"][dt], shapes=rows,
            train=run, train_by_model=runs, grad_checks=checks,
            **({"grad_check": train["grad_check"]} if dt == "bf16" else {})))
    # no TPU kernel behind it either: the JAX package trains rwkv6 by
    # autodiff of its plain checkpointed scan (its Pallas WKV6 is forward-only)
    wb_rows = train["wkv6_rows"]
    main = next(r for r in wb_rows if r["shape"] == "rwkv6_train_4x256")
    kernels.append(dict(
        name="wkv6_backward", route="cuda",
        source="src/repro_torch/kernels/rwkv6_wkv/csrc/wkv6_bwd.cu",
        replaces="src/repro/models/rwkv6.py:76", tpu_kernel=None,
        launches=train["rwkv6_run"]["wkv6_bwd_launches"],
        max_abs_err=max(r["max_abs_err"] for r in wb_rows),
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None, at="rwkv6_train_4x256",
        fma_bound_ms=main["fma_bound_ms"], build=train["wkv6_build"], shapes=wb_rows, train=train["rwkv6_run"],
        train_f32=train["rwkv6_run_f32"], grad_check=train["rwkv6_grad_check"]))
    print(f"total {time.perf_counter() - t_start:.1f}s on {card}")
    print(json.dumps({"sharding": {"sharded_launches": sharded, "dryrun": shard["dryrun"]}},
                     default=str))
    print(json.dumps({"ssd": ssd_rows}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


#: The served decode shapes of internvl2-1b (KV 2, G 7, D 64),
#: granite-moe-3b-a800m (KV 8, G 3, D 64), deepseek-moe-16b (KV 16, G 1,
#: D 128) and deepseek-67b (KV 8, G 8, D 128): name -> (KV, G, D).  The
#: kernel tiles the query heads in groups of 4, so G 3 and G 7 end in a
#: partly masked tile.
SERVED_DECODE_HEADS = [("g7", (2, 7, 64)), ("g3", (8, 3, 64)), ("g1", (16, 1, 128)),
                       ("g8", (8, 8, 128))]

#: gemma3-27b's local layers: a ring of 1024 slots, rows before, at and
#: after the first wrap, and far past it; flash-decode reads the ring at
#: min(cur, 1023)
RING_SLOTS = 1024
RING_CUR = [0, 1, 511, 1022, 1023, 1024, 1500, 3000]

#: The decode reads of the slice-10 models, bfloat16 cache [B,KV,S,D]:
#: name -> (B, KV, G, D, S, index).  whisper-large-v3's cross cache (the
#: 1500 frames, read at F - 1 = 1499 every step: 1500 is no multiple of the
#: split's chunk, so its last chunk is partial) and its self cache (the
#: 448-token decoder context, a scalar index mid-cache) at the smoke's
#: generate batch of 4; zamba2-1.2b's shared block over its served cache
#: (8 slots, 1024 positions, a per-slot index).
SLICE10_DECODE = [
    ("fp_whisper_cross_1500", (4, 20, 1, 64, 1500, 1499)),
    ("fp_whisper_self_448", (4, 20, 1, 64, 448, 200)),
    ("fp_zamba2_served", (8, 32, 1, 64, 1024, None)),
]


def nan_partials(torch):
    """Context: every flash-decode call fills its partials with NaN before
    the split kernel writes them (``ops._partials`` patched here; the
    package has no flag for it).  A combine that read them before the
    split's writes (a missing ``griddepcontrol.wait``) returns NaN, where
    ``torch.empty`` could hand it the right values of the previous identical
    call."""
    import contextlib

    from repro_torch.kernels.decode_attention import ops

    @contextlib.contextmanager
    def patched():
        real = ops._partials

        def filled(q, cache, s):
            acc, ml = real(q, cache, s)
            acc.fill_(float("nan"))
            ml.fill_(float("nan"))
            return acc, ml
        ops._partials = filled
        try:
            yield
        finally:
            ops._partials = real
    return patched()


def decode_kernel_phase(torch, F, dev, randn) -> list:
    """Flash-decode, float (bfloat16) and int8 cache, both layouts, at B 8,
    KV 8, G 2, D 128, S 32768: a mixed per-row index and a full-cache scalar
    index; and at the served shape, S 1024 in the serving layout, with a
    mixed index on both sides of the chunk edges; chatglm3-6b's served
    shape (KV 2, G 16) and the new models' (`SERVED_DECODE_HEADS`: G 7, 3,
    1 and 8) over both caches; gemma3-27b's local-layer ring (KV
    16, G 2, 1024 slots) at the clamped index, held against
    ``attention_decode_ring``'s plain version at the unclamped one (in
    float32 on the same numbers, rounded to bfloat16); the slice-10 reads
    (`SLICE10_DECODE`: whisper's cross cache at S 1500 and self cache at
    S 448, zamba2's served shared block).  The call held against the plain
    version runs with its partials filled with NaN (`nan_partials`).  The
    bound counts the cache positions this call's indices cover.  Kernel, plain version and
    SDPA are timed by `device_ms` (the served caches rotate over copies
    that hold ROTATION_BYTES; one S 32768 call reads more than the L2
    holds), with the single call's time beside it as call_ms."""
    from repro_torch.kernels import decode_attention as K
    from repro_torch.models.layers import attention_decode_ring

    b, kv, g, d, s_long, s_served = 8, 8, 2, 128, 32768, 1024
    cur_long = [32767, 20000, 4095, 1, 0, 32767, 16383, 8191]
    cur_served = [1023, 700, 511, 256, 255, 1, 0, 64]
    q = randn(b, kv, g, d).bfloat16()
    kc, vc = randn(b, kv, s_long, d).bfloat16(), randn(b, kv, s_long, d).bfloat16()
    kn, vn = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    (kqn, ks), (vqn, vs) = K.quantize_kv(kn), K.quantize_kv(vn)
    kqc, vqc = kqn.transpose(1, 2).contiguous(), vqn.transpose(1, 2).contiguous()

    def served_heads(n_kv, g, dd, bb=b, ss=s_served):
        """q [B,KV,G,D] and the served caches [B,KV,S,D] (S 1024 unless
        given): (bfloat16 k, v) and (int8 k, v, k scale, v scale)."""
        qs = randn(bb, n_kv, g, dd).bfloat16()
        ks_, vs_ = randn(bb, ss, n_kv, dd), randn(bb, ss, n_kv, dd)
        (kq_, ksc), (vq_, vsc) = K.quantize_kv(ks_), K.quantize_kv(vs_)
        kb, vb, kq_, vq_ = (x.transpose(1, 2).contiguous()
                            for x in (ks_.bfloat16(), vs_.bfloat16(), kq_, vq_))
        return qs, (kb, vb), (kq_, vq_, ksc, vsc)

    q16, fp16, i816 = served_heads(2, 16, d)
    q_ring = randn(b, 16, 2, d).bfloat16()
    k_ring, v_ring = (randn(b, 16, RING_SLOTS, d).bfloat16() for _ in range(2))
    ring_cur = torch.tensor(RING_CUR, dtype=torch.int32, device=dev)
    heads = {name: served_heads(*shape) for name, shape in SERVED_DECODE_HEADS}

    def served(*xs):    # the first 1024 positions, [B,KV,S,...] caches
        return tuple(x[:, :, :s_served].contiguous() for x in xs)

    def ring_ref(qc, kr, vr, _clamped, seq_axis=2):
        """attention_decode_ring at the unclamped index, float32."""
        bb, n, gg, dd = qc.shape
        return attention_decode_ring(qc.reshape(bb, n * gg, dd).float(), kr.float(),
                                     vr.float(), ring_cur).reshape(qc.shape).to(qc.dtype)
    fp = (K.decode_attention_grouped, K.decode_ref)
    i8 = (K.decode_attention_int8_grouped, K.decode_int8_ref)
    ring = (K.decode_attention_grouped, ring_ref)
    clamped = [min(c, RING_SLOTS - 1) for c in RING_CUR]
    cases = [
        # name, kind, (kernel, plain), q, cache args, seq_axis, S, index
        ("fp_cache_vector", "fp", fp, q, (kc, vc), 2, s_long, cur_long),
        ("fp_native_vector", "fp", fp, q, (kn, vn), 1, s_long, cur_long),
        ("fp_cache_scalar", "fp", fp, q, (kc, vc), 2, s_long, s_long - 1),
        ("fp_served_vector", "fp", fp, q, served(kc, vc), 2, s_served, cur_served),
        ("fp_served_g16", "fp", fp, q16, fp16, 2, s_served, cur_served),
        ("ring_1024_clamped", "fp", ring, q_ring, (k_ring, v_ring), 2, RING_SLOTS,
         clamped),
        ("int8_cache_vector", "int8", i8, q, (kqc, vqc, ks, vs), 2, s_long, cur_long),
        ("int8_native_vector", "int8", i8, q, (kqn, vqn, ks, vs), 1, s_long, cur_long),
        ("int8_cache_scalar", "int8", i8, q, (kqc, vqc, ks, vs), 2, s_long, s_long - 1),
        ("int8_served_vector", "int8", i8, q, served(kqc, vqc, ks, vs), 2, s_served,
         cur_served),
        ("int8_served_g16", "int8", i8, q16, i816, 2, s_served, cur_served),
    ]
    for name, (qh, fph, i8h) in heads.items():
        cases += [(f"fp_served_{name}", "fp", fp, qh, fph, 2, s_served, cur_served),
                  (f"int8_served_{name}", "int8", i8, qh, i8h, 2, s_served, cur_served)]
    for name, (bb, n_kv, g, dd, ss, cur) in SLICE10_DECODE:
        qh, fph, _ = served_heads(n_kv, g, dd, bb, ss)
        cases.append((name, "fp", fp, qh, fph, 2, ss,
                      cur_served[:bb] if cur is None else cur))
    rows = []
    for name, kind, (kernel, plain), q, cache, seq_axis, s, cur_list in cases:
        b, kv, g, d = q.shape
        vector = isinstance(cur_list, list)
        cur_t = torch.tensor(cur_list, dtype=torch.int32, device=dev)
        cur = cur_t if vector else cur_list   # the kernel takes an int as it is
        sets = rotation((q,) + cache)

        def run_kernel(c=sets[0]):
            return kernel(*c, cur, seq_axis=seq_axis)

        def run_plain(c=sets[0]):             # a device index: no host copy
            return plain(*c, cur_t, seq_axis=seq_axis)
        with nan_partials(torch):
            out = run_kernel()
            torch.cuda.synchronize()
        err, use = limit_errs(out, run_plain())
        finite = bool(torch.isfinite(out).all())
        ms, plain_ms, call_ms, plain_call_ms = kernel_and_plain_ms(
            torch, [lambda c=c: run_kernel(c) for c in sets],
            [lambda c=c: run_plain(c) for c in sets], 10, force=True)
        positions = sum(min(c, s - 1) + 1 for c in (cur_list if vector else [cur] * b))
        qo_bytes = 2 * b * kv * g * d * 2
        if kind == "fp":
            nbytes = positions * kv * d * 2 * 2 + qo_bytes
            bound_ms, bound_by = bound(nbytes, 4 * positions * kv * g * d,
                                       BF16_FLOPS_PER_S)
            mask = (torch.arange(s, device=dev)[None, :]
                    <= cur_t.reshape(-1).expand(b)[:, None])[:, None, None, :]

            def library(qc, kl, vl):
                if seq_axis == 1:
                    kl, vl = kl.transpose(1, 2), vl.transpose(1, 2)
                return F.scaled_dot_product_attention(
                    qc.reshape(b, kv * g, 1, d), kl, vl, attn_mask=mask,
                    enable_gqa=True)
            lib_err = float((library(*sets[0]).reshape(out.shape).float()
                             - out.float()).abs().max())
            library_ms, library_call_ms = library_times(
                torch, [lambda c=c: library(*c) for c in sets], 10, force=True)
        else:
            nbytes = positions * kv * (d * 2 + 4 * 2) + qo_bytes
            bound_ms, bound_by = bound(nbytes, 4 * positions * kv * g * d,
                                       INT8_OPS_PER_S)
            library_ms = library_call_ms = lib_err = None
        row = dict(shape=name, kind=kind, q=[b, kv, g, d], seq_len=s,
                   layout="[B,KV,S,D]" if seq_axis == 2 else "[B,S,KV,D]",
                   cur_index=cur_list, max_abs_err=err, bf16_limit_use=use,
                   ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                   plain_call_ms=plain_call_ms, bound_ms=bound_ms,
                   bound_by=bound_by, bound_share=bound_ms / ms,
                   library_ms=library_ms, library_call_ms=library_call_ms,
                   bytes=nbytes, copies=len(sets))
        rows.append(row)
        print(f"decode {name:18s} q={row['q']} S={s} {row['layout']}: NaN partials, "
              f"max_err={err:.3g} ({use:.3f} of the bf16 limit) ms={ms:.5f} "
              f"call_ms={call_ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms if library_ms is None else round(library_ms, 5)} "
              f"(call {library_call_ms if library_call_ms is None else round(library_call_ms, 4)}; "
              f"library vs kernel {lib_err if lib_err is None else round(lib_err, 5)}) "
              f"bound_ms={bound_ms:.5f} ({bound_by}, {nbytes / 1e9:.4f} GB; "
              f"{bound_ms / ms:.1%} of it) over {len(sets)} cache copies")
        check(finite, f"decode {name}: non-finite output over NaN-filled partials "
                      f"(the combine read them before the split wrote them)")
        check(use <= 1.0, f"decode {name}: max_err {err}, {use} of the bf16 limit "
                          f"|a-b| <= {BF16_RTOL} |b| + {BF16_ATOL}")
        del sets
    return rows


#: The bfloat16 flash prefill's cases: name, (B, Sq, Sk, H, KV, D), causal,
#: repetitions.  qwen3-1.7b's heads (16 query heads over 8 kv heads of 128)
#: at a served 512-token prompt, one of 2500 and one of 4096; a causal GQA
#: batch of 2 with a ragged tail; a non-causal Sq != Sk case with ragged
#: tails at D 64; chatglm3-6b's heads (32 over 2: groups of 16) at a served
#: 512-token prompt; gemma3-27b's global layers' (32 over 16) at a served
#: 1500-token prompt; at a served 512-token prompt, internvl2-1b's (14 over
#: 2 of 64: groups of 7), granite-moe-3b-a800m's (24 over 8 of 64: groups
#: of 3), deepseek-moe-16b's (16 over 16) and deepseek-67b's (64 over 8);
#: whisper-large-v3's encoder self-attention over its 1500 frames and its
#: decoder's cross-attention of 64 prompt tokens over them (20 heads of 64,
#: non-causal, Sk 1500 ending in a partial key tile), and zamba2-1.2b's
#: shared block at a 512-token prompt (32 over 32 of 64).
FLASH_BF16_CASES = [
    ("qwen3_prefill_512", (1, 512, 512, 16, 8, 128), True, 10),
    ("qwen3_prefill_2500", (1, 2500, 2500, 16, 8, 128), True, 10),
    ("causal_gqa_333", (2, 333, 333, 16, 8, 128), True, 10),
    ("ragged_1000_777", (1, 1000, 777, 8, 8, 64), False, 10),
    ("long_4096", (1, 4096, 4096, 16, 8, 128), True, 5),
    ("chatglm3_prefill_512", (1, 512, 512, 32, 2, 128), True, 10),
    ("gemma3_prefill_1500", (1, 1500, 1500, 32, 16, 128), True, 10),
    ("internvl2_prefill_512", (1, 512, 512, 14, 2, 64), True, 10),
    ("granite_prefill_512", (1, 512, 512, 24, 8, 64), True, 10),
    ("dsmoe_prefill_512", (1, 512, 512, 16, 16, 128), True, 10),
    ("deepseek67b_prefill_512", (1, 512, 512, 64, 8, 128), True, 10),
    ("whisper_encoder_1500", (1, 1500, 1500, 20, 20, 64), False, 10),
    ("whisper_cross_64x1500", (1, 64, 1500, 20, 20, 64), False, 10),
    ("zamba2_prefill_512", (1, 512, 512, 32, 32, 64), True, 10),
    ("qwen3_train_4x256_v128", (4, 256, 256, 16, 8, 128), True, 10),
    ("zamba2_train_512_v128", (1, 512, 512, 32, 32, 64), True, 10),
]
#: The cases drawn with V x V_SCALE (exact in bfloat16; q, k and dO stay
#: N(0, 1)), as the init rule's weights make v on qwen3-1.7b's and
#: zamba2-1.2b's layer inputs (|v| ~ 150, scores ~ 5: a spread softmax
#: whose output cancels).  The plain float32 path lies past the elementwise
#: limit from float64 there, so it is no yardstick: each output is held
#: from the float64 result, at the limit plus F32_TERM_STEPS float32
#: roundings (2^-24) of the sum of the magnitudes of the terms the element
#: sums (`attention_f64`'s magnitudes).  A cancelling element of o, dq or
#: dk sums terms thousands of times its size, so the limit's 1e-5 alone
#: lies below float32's resolution of them, and no float32 computation
#: meets it: dq's error is set by dP = dO V^T's float32 sums, in the plain
#: path as in the kernels.  One rounding of the terms still tells P and dS
#: in two bfloat16 terms (2^-17 of each term) from three.  The bare limit's
#: measure, the plain path's and the kernels' arithmetic emulated
#: (`split_readings`) are printed beside.
FROM_F64_CASES = ("qwen3_train_4x256_v128", "zamba2_train_512_v128")
V_SCALE = 2 ** 7
FROM_F64_SEED = 0
F32_TERM_STEPS = 1.0


def from_f64_inputs(torch, dev, b, sq, sk, h, kv, d) -> list:
    """q, k, v x V_SCALE and dO of a `FROM_F64_CASES` case in bfloat16,
    drawn on the CPU from FROM_F64_SEED (so that the CPU can redo the
    kernels' arithmetic on the same inputs), then moved to ``dev``."""
    gen = torch.Generator().manual_seed(FROM_F64_SEED)
    q = torch.randn(b, sq, h, d, generator=gen).bfloat16()
    k = torch.randn(b, sk, kv, d, generator=gen).bfloat16()
    v = torch.randn(b, sk, kv, d, generator=gen).bfloat16() * V_SCALE
    do = torch.randn(b, sq, h, d, generator=gen).bfloat16()
    return [x.to(dev) for x in (q, k, v, do)]


def sass_report(lib_path, kernel: str, instr: str) -> dict:
    """Each instantiation of ``kernel`` in the library, by its mangled name:
    the count of ``instr`` in its SASS, and its registers, spills and any
    note on wgmma from ptxas."""
    import re

    from repro_torch.kernels import _build
    from torch.utils.cpp_extension import CUDA_HOME

    entry, report = None, {}
    for line in (_build.BUILD_DIR / "ptxas.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if kernel in m.group(1) else None
            continue
        if entry is None:
            continue
        r = report.setdefault(entry, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            r["spill"] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            r["registers"] = int(m.group(1))
        if "wgmma" in line:
            note = line.split("info    :")[-1].split(" in the function")[0].strip()
            r.setdefault("wgmma_notes", []).append(note)
    sass = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass",
                           str(lib_path)], capture_output=True, text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump: {sass.stderr.strip()[:500]}")
    found = {}
    for func in sass.stdout.split("Function : ")[1:]:
        name = func.splitlines()[0].strip()
        if kernel in name:
            found[name] = dict(report.get(name, {}), count=func.count(instr))
    check(len(found) > 0, f"{kernel} not in the library's SASS")
    return found


def flash_build_report(lib_path, kernel: str) -> int:
    """A flash kernel's build (``kernel``: ``flash_fwd_f32`` or
    ``flash_fwd_bf16``, both on the tensor cores): each instantiation's
    registers and spills from ptxas, any wgmma serialisation ptxas reports,
    and the count of warpgroup MMA instructions (HGMMA) in its SASS.  Fails
    if an instantiation holds none: it would not be on the tensor cores."""
    import re

    label = kernel.rsplit("_", 1)[-1]
    total = 0
    for name, r in sass_report(lib_path, kernel, "HGMMA").items():
        n = r["count"]
        total += n
        dim = re.search(kernel + r"ILi(\d+)E", name).group(1)
        print(f"flash {label} build: D={dim}: "
              f"HGMMA {n}, registers {r.get('registers')}, spill stores/loads "
              f"{r.get('spill')} bytes; ptxas on wgmma: {r.get('wgmma_notes', 'nothing')}")
        check(n > 0, f"flash {label}: no HGMMA in {name}")
    print(f"flash {label} build: {total} HGMMA instructions in {kernel}'s SASS")
    return total


def decode_build_report(lib_path) -> int:
    """The flash-decode split kernel's build: for each of its 24
    instantiations (cache and query type, D, group tile) the bulk copies by
    the TMA (UBLKCP) in its SASS and its registers and spills from ptxas.
    Fails if one holds no bulk copy or spills."""
    from torch.utils.cpp_extension import CUDA_HOME

    found = sass_report(lib_path, "decode_split", "UBLKCP")
    names = list(found)
    filt = subprocess.run([os.path.join(CUDA_HOME, "bin", "cu++filt")],
                          input="\n".join(names), capture_output=True, text=True,
                          timeout=60)
    readable = (filt.stdout.splitlines() if filt.returncode == 0 else names)
    total = 0
    for name, label in zip(names, readable):
        r = found[name]
        total += r["count"]
        label = label[:label.rfind(">(") + 1] or label   # the template, no parameters
        for junk in ("void ", "<unnamed>::", "(anonymous namespace)::", "(int)"):
            label = label.replace(junk, "")
        print(f"decode build: {label}: UBLKCP {r['count']}, registers "
              f"{r.get('registers')}, spill stores/loads {r.get('spill')} bytes")
        check(r["count"] > 0, f"decode: no bulk copy in {label}")
        check(r.get("spill", (0, 0)) == (0, 0), f"decode: {label} spills")
    print(f"decode build: {total} UBLKCP instructions in {len(found)} "
          f"instantiations of decode_split")
    check(len(found) == 24, f"decode: {len(found)} instantiations of decode_split")
    return total


def flash_bf16_phase(torch, F, dev, randn, names=None) -> list:
    """The bfloat16 flash prefill (``flash_attention_bf16.cu``, on the tensor
    cores) against its plain version, each element within one bfloat16 step
    (`FROM_F64_CASES`: of the float64 result); its time beside SDPA's
    (``scaled_dot_product_attention`` on the same problem) and its bound by
    the bfloat16 tensor-core rate.  ``names``: those cases only."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import attention_ref

    rows = []
    for name, (b, sq, sk, h, kv, d), causal, reps in FLASH_BF16_CASES:
        if names is not None and name not in names:
            continue
        if name in FROM_F64_CASES:
            q, k, v, _ = from_f64_inputs(torch, dev, b, sq, sk, h, kv, d)
        else:
            q = randn(b, sq, h, d).bfloat16()
            k, v = randn(b, sk, kv, d).bfloat16(), randn(b, sk, kv, d).bfloat16()
        out = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err, use = limit_errs(out, attention_ref(q, k, v, causal=causal))
        against, bare = "the plain version", None
        if name in FROM_F64_CASES:
            vs_plain = use
            exact, mags = attention_f64(torch, q, k, v, out, out, causal, d ** -0.5,
                                        magnitudes=True)
            floor = F32_TERM_STEPS * 2.0 ** -24 * mags[0]
            bare = limit_errs(out, exact[0])[1]
            err, use = limit_errs(out, exact[0], floor=floor)
            plain = attention_ref(q, k, v, causal=causal)
            plain_use = limit_errs(plain, exact[0], floor=floor)[1]
            plain_bare = limit_errs(plain, exact[0])[1]
            against = (f"float64, with {F32_TERM_STEPS:g} float32 step of its terms; the bare "
                       f"limit {bare:.3f}; against the plain version {vs_plain:.3f}; the plain "
                       f"version from float64 {plain_use:.3f}, bare {plain_bare:.3f}")
            del exact, mags, floor, plain
        del out
        sets = rotation((q, k, v))
        ms, plain_ms, call_ms, plain_call_ms = kernel_and_plain_ms(
            torch, [lambda c=c: flash_attention(*c, causal=causal) for c in sets],
            [lambda c=c: attention_ref(*c, causal=causal) for c in sets], reps)
        library_ms, library_call_ms = library_times(
            torch, [lambda c=c: F.scaled_dot_product_attention(
                *(x.transpose(1, 2) for x in c), is_causal=causal,
                enable_gqa=h != kv) for c in sets], reps,
            force=call_ms < DEVICE_TIME_BELOW_MS)
        pairs = sq * (sq + 1) // 2 if causal else sq * sk
        bound_ms, bound_by = bound(2 * (2 * b * sq * h * d + 2 * b * sk * kv * d),
                                   4.0 * b * h * pairs * d, BF16_FLOPS_PER_S)
        row = dict(shape=name, q=[b, sq, h, d], kv=[b, sk, kv, d], causal=causal,
                   dtype="bfloat16", max_abs_err=err, bf16_limit_use=use,
                   held_from="float64" if name in FROM_F64_CASES else "plain",
                   bare_limit_use=bare, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                   plain_call_ms=plain_call_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms, library_call_ms=library_call_ms,
                   vs_library=ms / library_ms, bound_share=bound_ms / ms)
        rows.append(row)
        print(f"flash {name} q={row['q']} kv={row['kv']} bf16 causal={causal}: "
              f"max_err={err:.3g} ({use:.3f} of the bf16 limit from {against}) ms={ms:.4f} "
              f"call_ms={call_ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={library_ms:.4f} "
              f"(kernel/sdpa {ms / library_ms:.2f}x) bound_ms={bound_ms:.4f} "
              f"({bound_by}; {bound_ms / ms:.1%} of it)")
        check(use <= 1.0, f"flash bf16 {name}: max_err {err}, {use} of the bf16 "
                          f"limit |a-b| <= {BF16_RTOL} |b| + {BF16_ATOL}")
        del q, k, v, sets
    return rows


#: card vs CPU, float32: prefill logits within this share of the largest
LLM_SMALL_RTOL = 1e-4
#: The small models whose float32 logits at the JAX init rule's weights sit
#: near LLM_SMALL_RTOL from the exact ones by themselves: the rule draws a
#: stacked leaf with std 1/sqrt(layers) (0.71 at 2 layers), and reduced
#: whisper's encoder, decoder and cross-attention compound it (its CPU
#: float32 logits lie 1.0e-4 of the largest from a float64 run of the same
#: weights, as this phase prints).  For these the smoke also
#: runs the CPU in float64 and holds the card's and the CPU's float32
#: logits to max(LLM_SMALL_RTOL, F64_FLOOR_FACTOR x the CPU's float32
#: distance from float64), both against the CPU and against float64.
F64_FLOOR = {"whisper-large-v3"}
F64_FLOOR_FACTOR = 2.0


#: The small phase's language models: (label, arch, overrides of the reduced
#: float32 config, prompt lengths).  chatglm3-6b at groups of 16 (16 query
#: heads over 1 kv head, as the full model's 32 over 2); gemma3-27b at 8
#: layers (one period of 5 local layers and 1 global one, 2 local tail
#: layers) with a window of 16: a 12-token prompt wraps its rings during
#: the 16 decode steps, a 20-token one in the prefill; deepseek-moe-16b
#: reduced (its dense layer 0, then a MoE layer of 4 experts, top-2, 1
#: shared); granite-moe-3b-a800m at the full model's 24 query heads over 8;
#: internvl2-1b at its 14 over 2, with 16 patch embeddings over the first
#: positions of the prefill; whisper-large-v3 reduced (2 encoder and 2
#: decoder layers) over 16 random frames; zamba2-1.2b at 5 layers with the
#: shared block after every 2 (two places and a tail layer).
SMALL_LLM = [
    ("qwen3-1.7b", "qwen3-1.7b", {}, [12]),
    ("chatglm3-6b g16", "chatglm3-6b", dict(num_heads=16, num_kv_heads=1), [12]),
    ("gemma3-27b 8 layers window 16", "gemma3-27b",
     dict(num_layers=8, sliding_window=16), [12, 20]),
    ("deepseek-moe-16b (1 dense, 1 MoE layer)", "deepseek-moe-16b", {}, [12]),
    ("granite-moe-3b-a800m 24/8 heads", "granite-moe-3b-a800m",
     dict(num_heads=24, num_kv_heads=8), [12]),
    ("internvl2-1b 14/2 heads with patch embeddings", "internvl2-1b",
     dict(num_heads=14, num_kv_heads=2), [20]),
    ("whisper-large-v3 with random frames", "whisper-large-v3", {}, [12]),
    ("zamba2-1.2b 5 layers, shared block every 2", "zamba2-1.2b",
     dict(num_layers=5, hybrid_attn_every=2), [12, 2]),
]


def llm_small_phase(torch, np, dev) -> None:
    """The reduced float32 engines (`SMALL_LLM`) on the card against the
    same engines on the CPU, on the same weights: prefill logits, greedy
    tokens, and the flash and decode kernels launched on the card."""
    import dataclasses

    from repro_torch.kernels import decode_attention_grouped, flash_attention
    from repro_torch.launch.serve import llm_config
    from repro_torch.serving import ServingEngine

    for label, arch, overrides, prompt_lens in SMALL_LLM:
        cfg = dataclasses.replace(llm_config(arch, "small"), **overrides)
        cpu = ServingEngine(cfg, max_len=64, seed=0, device="cpu")
        card = ServingEngine(cfg, params=_to(torch, cpu.params, dev), max_len=64,
                             device=dev)
        for plen in prompt_lens:
            rng = np.random.default_rng(3)
            prompts = rng.integers(0, cfg.vocab_size, (2, plen)).astype(np.int32)
            pe = fr = None
            if cfg.family == "vlm":   # as the token embeddings' scale
                pe = (rng.standard_normal((2, min(cfg.frontend_tokens, plen),
                                           cfg.d_model)) * 0.006).astype(np.float32)
            if cfg.family == "audio":
                fr = rng.standard_normal((2, cfg.frontend_tokens, cfg.d_model)
                                         ).astype(np.float32)
            launches = (flash_attention.launches, decode_attention_grouped.launches)
            lc, lg = cpu.prefill(prompts, pe, fr)[0], card.prefill(prompts, pe, fr)[0].cpu()
            err = float((lc - lg).abs().max() / lc.abs().max())
            toks_cpu = cpu.generate(prompts, steps=16, patch_embeds=pe, frames=fr).tokens
            toks_card = card.generate(prompts, steps=16, patch_embeds=pe, frames=fr).tokens
            fl = flash_attention.launches - launches[0]
            dc = decode_attention_grouped.launches - launches[1]
            tol, floor = LLM_SMALL_RTOL, ""
            if arch in F64_FLOOR:
                exact = ServingEngine(dataclasses.replace(cfg, dtype="float64"),
                                      params=_to64(torch, cpu.params), max_len=64,
                                      device="cpu")
                l64 = exact.prefill(prompts, pe, fr if fr is None else
                                    fr.astype(np.float64))[0]
                cpu64, card64 = (float((x.double() - l64).abs().max() / l64.abs().max())
                                 for x in (lc, lg))
                tol = max(LLM_SMALL_RTOL, F64_FLOOR_FACTOR * cpu64)
                floor = (f"; against float64: cpu {cpu64:.3g}, card {card64:.3g}")
                check(card64 <= tol, f"small {label}: the card's logits lie {card64:.3g} "
                                     f"from float64, over {tol:.3g}")
            print(f"small llm: {label} reduced float32, prompt {plen}: prefill "
                  f"logits card vs cpu max_err/max|l|={err:.3g} (tol {tol:.3g}{floor}); "
                  f"greedy tokens equal: "
                  f"{bool(np.array_equal(toks_cpu, toks_card))}; launches flash={fl} "
                  f"decode={dc}")
            check(fl > 0 and dc > 0,
                  f"the small {label} run on the card did not launch the kernels")
            check(err <= tol, f"small {label}: prefill logits differ from the CPU")
            check(np.array_equal(toks_cpu, toks_card),
                  f"small {label}: greedy tokens differ")


#: The transformers served at full width in bfloat16 through llm_disagg,
#: each at full depth but deepseek-67b (38 of 95 layers, its PORT_LAYERS):
#: arch -> (max_len, runs of (label, cache type, prompt lengths)).
#: gemma3-27b's 1500- and 1200-token prompts wrap its 1024-slot rings in the
#: prefill, its 1010- and 1020-token ones during the 32 decode steps; it has
#: no int8 cache.  internvl2-1b serves text only, as the JAX engine does.
#: zamba2-1.2b's prompts of 64-256 tokens run its chunked SSD scan, 38 x
#: ceil(P / 64) chunk steps a prefill; it has no int8 cache.
LLM_SERVED = {
    "qwen3-1.7b": (1024, [("bf16 cache", "", [64, 512, 128, 256, 384, 96, 200, 448]),
                          ("int8 cache", "int8", [64, 512, 160, 320])]),
    "chatglm3-6b": (1024, [("bf16 cache", "", [64, 512, 128, 256, 384, 96, 200, 448]),
                           ("int8 cache", "int8", [64, 512, 160, 320])]),
    "gemma3-27b": (2048, [("bf16 cache", "",
                           [64, 1500, 1010, 256, 1200, 128, 700, 1020])]),
    "internvl2-1b": (1024, [("bf16 cache", "", [64, 512, 128, 256, 384, 96, 200, 448]),
                            ("int8 cache", "int8", [64, 512, 160, 320])]),
    "granite-moe-3b-a800m": (1024, [("bf16 cache", "",
                                     [64, 512, 128, 256, 384, 96, 200, 448])]),
    "deepseek-moe-16b": (1024, [("bf16 cache", "",
                                 [64, 512, 128, 256, 384, 96, 200, 448])]),
    "deepseek-67b": (1024, [("bf16 cache", "", [64, 512, 160, 320])]),
    "zamba2-1.2b": (1024, [("bf16 cache", "", [64, 256, 128, 192, 96, 160, 224, 80])]),
}


def attention_layers(cfg):
    """(flash launches a prefill, flash-decode launches a decode step): a
    transformer's full-attention layers and all of its layers; zamba2's
    shared block once per place for both."""
    from repro_torch.models import mamba2, transformer

    if cfg.family == "hybrid":
        n = mamba2._periods(cfg)[0]
        return n, n
    return sum(1 for *_, w in transformer.layer_slots(cfg) if not w), cfg.num_layers


def llm_serving_phase(torch, np, dev, arch: str) -> dict:
    """``arch`` at full width and depth in bfloat16 through the llm_disagg
    Workflow Set, 8 slots, segments of 8, 32 new tokens, half greedy and half
    at 0.7, once per run of `LLM_SERVED`.  Every request answered, nothing
    dropped, flash launched once per full-attention layer and prefill
    (gemma3's local layers attend in plain PyTorch), flash-decode once per
    layer and decode step (zamba2: once per place of its shared block for
    both), every stream equal to its solo ``generate``; zamba2's batch-1
    against batch-8 differences 0.  Returns the launch counts of the served
    runs."""
    import dataclasses

    from repro_torch.kernels import (
        decode_attention_grouped,
        decode_attention_int8_grouped,
        flash_attention,
    )
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import check_served, llm_config, llm_requests, serve
    from repro_torch.models import mamba2, registry
    from repro_torch.serving import APP_LLM_DISAGG, ServingEngine, build_llm_disagg_set
    from repro_torch.serving.disagg import ring_bytes_for

    slots, segment, steps = 8, 8, 32
    max_len, runs = LLM_SERVED[arch]
    cfg = llm_config(arch, "port")
    tag = cfg.name if cfg.num_layers == get_config(arch).num_layers else \
        f"{cfg.name} ({cfg.num_layers} layers)"
    full_layers, decode_layers = attention_layers(cfg)
    print(f"{tag}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
          f"before the engine")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, max_len=max_len, seed=0)
    torch.cuda.synchronize()
    n_params = registry.count_params(cfg)
    n_active = registry.count_active_params(cfg)
    experts = (f" {cfg.num_experts} experts of d_ff {cfg.d_ff} (top-{cfg.top_k}, "
               f"{cfg.num_shared_experts} shared, {cfg.first_dense_layers} dense "
               f"layers of d_ff {cfg.dense_ff})" if cfg.num_experts else "")
    if cfg.family == "hybrid":
        d_inner, n_heads, conv_dim, _ = mamba2._dims(cfg)
        experts = (f" (Mamba2: d_inner {d_inner}, {n_heads} SSM heads of "
                   f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, conv_dim {conv_dim}; "
                   f"the shared block's {cfg.num_heads} heads after every "
                   f"{cfg.hybrid_attn_every} layers)")
    print(f"{tag}: {cfg.num_layers} layers ({full_layers} with full attention) "
          f"d_model {cfg.d_model} {cfg.num_heads}/{cfg.resolved_kv_heads} heads of "
          f"{cfg.resolved_head_dim} d_ff {cfg.d_ff}{experts} vocab {cfg.vocab_padded} "
          f"in {cfg.dtype}: {n_params:,} params ({n_active:,} active a token) on "
          f"{engine.device} in {time.perf_counter() - t0:.1f}s (peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB while drawing them); "
          f"a decode step reads {2 * n_params / 1e9:.2f} GB of weights "
          f"({2 * n_active / 1e9:.2f} GB active); decode inbox "
          f"{ring_bytes_for(cfg, max_len, max_slots=slots) / 1e6:.1f} MB of host "
          f"memory at max_len "
          f"{max_len}")

    d_logits, d_cache = batch_width_diff(torch, np, engine, slots, dev, tag)
    if cfg.family == "hybrid":
        check(d_logits == 0 and d_cache == 0,
              f"{tag}: a request decodes other numbers as row 0 of a batch of "
              f"{slots} than alone (logits {d_logits}, cache {d_cache})")
    rng = np.random.default_rng(5)
    counts = {}
    for label, cache_dtype, prompt_lens in runs:
        rcfg = dataclasses.replace(cfg, cache_dtype=cache_dtype)
        int8 = rcfg.resolved_cache_dtype == "int8"
        decode_kernel = decode_attention_int8_grouped if int8 else decode_attention_grouped
        counter = decode_kernel.__name__
        eng = engine if rcfg == cfg else ServingEngine(
            rcfg, params=engine.params, max_len=max_len)
        reqs = llm_requests(rcfg, rng, prompt_lens, steps, [0.0, 0.7])
        ws, decoder = build_llm_disagg_set(eng, name=f"llm_{rcfg.resolved_cache_dtype}",
                                           max_slots=slots, segment_len=segment)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        decode_attention_grouped.launches = 0
        decode_attention_int8_grouped.launches = 0
        outs, lost, wall = serve(ws, reqs, app=APP_LLM_DISAGG, batched=True)
        stats = ws.transport_stats()
        fl, dc = flash_attention.launches, decode_kernel.launches
        peak = torch.cuda.max_memory_allocated()
        counts["flash_attention"] = counts.get("flash_attention", 0) + fl
        counts[counter] = counts.get(counter, 0) + dc
        decode_steps = decoder.stats["segments"] * segment
        print(f"serve {tag} {label}: {len(outs)}/{len(reqs)} answered, lost={lost}, "
              f"dropped={stats.dropped}, {wall:.2f}s wall, "
              f"{len(outs) * steps / wall:.1f} tokens/s, {stats.kv_pages} KVPages "
              f"{stats.kv_bytes / 1e6:.1f} MB ({stats.kv_bytes / max(stats.kv_pages, 1) / 1e6:.1f} "
              f"MB a request), segments={decoder.stats['segments']} "
              f"max_resident={decoder.stats['max_resident']}/{slots}; launches "
              f"flash={fl} ({fl / len(reqs):.0f} per prefill) decode={dc} "
              f"({dc / max(decode_steps, 1):.0f} per decode step), "
              f"max_memory_allocated={peak / 2**30:.2f} GiB")
        check(lost == 0 and len(outs) == len(reqs), f"{tag} {label}: requests lost")
        check(stats.dropped == 0, f"{tag} {label}: {stats.dropped} messages dropped")
        check(fl == full_layers * len(reqs), f"{tag} {label}: flash launches {fl}")
        check(dc == decode_layers * decode_steps and dc > 0,
              f"{tag} {label}: decode launches {dc} for {decode_steps} steps")

        for i, (r, out) in enumerate(zip(reqs, outs)):
            check(out.shape == (1, r["prompt"].shape[1] + steps),
                  f"{tag} {label}: request {i} tokens of shape {out.shape}")
            flash_attention.launches = decode_kernel.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            check_served(eng, [r], [out])     # raises if they differ
            dt = time.perf_counter() - t1
            print(f"  request {i}: prompt {r['prompt'].shape[1]} temperature "
                  f"{r['temperature']}: solo generate {dt * 1e3:.1f} ms "
                  f"({steps / dt:.1f} tokens/s), launches flash="
                  f"{flash_attention.launches} decode={decode_kernel.launches} "
                  f"({decode_kernel.launches / steps:.0f} per step), "
                  f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} "
                  f"GiB; served tokens equal solo generate")
            check(flash_attention.launches == full_layers
                  and decode_kernel.launches == decode_layers * steps,
                  f"{tag} {label}: request {i} solo generate launches")
        print(f"serve {tag} {label}: every request's tokens equal solo generate")
        del ws, decoder, eng
    del engine
    return counts


#: WKV6 y against its plain version, element by element:
#: |a - b| <= rtol |b| + WKV_ATOL_SHARE max|b|.  Kernel and plain version sum
#: y's products in another order, and float32 differences of that sum reach
#: 1e-5 where y is near zero, so the absolute part is scaled to the largest
#: |y|.  rtol: float32 2e-5; bfloat16 one bfloat16 step (2^-7), since both
#: round the same float32 y once.  The float32 state: 1e-4 absolute and
#: relative (the JAX package's WKV6 tests).
WKV_RTOL = {"float32": 2e-5, "bfloat16": 2 ** -7}
WKV_ATOL_SHARE = 1e-5
WKV_STATE_TOL = 1e-4


WKV_CHUNK, WKV_SUB = 64, 8      # time steps per chunk and per sub-chunk in wkv6.cu


def wkv6_operations(b: int, t: int, h: int, kk: int, v_exact: bool):
    """(tensor-core flops, CUDA-core flops, dependent chunk steps) of the
    chunked form for [B,T,H,K] (V = K), counting each chunk's real rows.
    Tensor cores, each multiply-add two flops and each product three TF32
    products (two where v is bfloat16, exact in TF32): y's state term and
    the state update, K V a row each; A V, 8 (a + 1) V a row of sub-chunk
    a (sub-chunks of 8 steps); A between sub-chunks, 8 a K.  CUDA cores:
    the pairs inside a sub-chunk (3 K a pair: the decay and a
    multiply-add), the bonus (3 K a row), the decays within sub-chunks (4 K
    a row) and the state's decay (2 K V a chunk)."""
    steps = -(-t // WKV_CHUNK)
    rows = [i % WKV_CHUNK for i in range(t)]
    sub = [i // WKV_SUB for i in rows]
    tc = 3 * (t * kk * kk + sum(WKV_SUB * a * kk for a in sub)) + \
        (2 if v_exact else 3) * (t * kk * kk + sum(WKV_SUB * (a + 1) * kk for a in sub))
    cc = sum(3 * kk * (i % WKV_SUB) + 7 * kk for i in rows) + steps * 2 * kk * kk
    return 2.0 * b * h * tc, 1.0 * b * h * cc, steps


def wkv6_model_decays(torch, gen, shape, dev):
    """w as rwkv6 draws it (models/rwkv6.py): exp(-exp(x)) rounded to
    bfloat16, here for x uniform over [-6, 4] (down to e^-54.6), with 1 %
    exact zeros and 1 % exact ones planted."""
    x = torch.rand(shape, generator=gen, device=dev) * 10 - 6
    w = torch.exp(-torch.exp(x)).bfloat16().float()
    pick = torch.rand(shape, generator=gen, device=dev)
    return torch.where(pick < 0.01, 0., torch.where(pick > 0.99, 1., w))


def wkv6_build_report(lib_path) -> int:
    """The WKV6 kernel's build: for each instantiation (input type, K) the
    tensor-core instructions (HMMA, from mma.sync) in its SASS and its
    registers and spills from ptxas.  Fails if one holds no HMMA or
    spills."""
    found = sass_report(lib_path, "wkv6_chunked", "HMMA")
    total = 0
    for name, r in found.items():
        label = ("bfloat16" if "nv_bfloat16" in name else "float32") + \
            ", K=" + name.split("Li")[-1].split("E")[0]
        total += r["count"]
        print(f"wkv6 build: wkv6_chunked<{label}>: HMMA {r['count']}, registers "
              f"{r.get('registers')}, spill stores/loads {r.get('spill')} bytes")
        check(r["count"] > 0, f"wkv6: no HMMA in {label}")
        check(r.get("spill", (0, 0)) == (0, 0), f"wkv6: {label} spills")
    print(f"wkv6 build: {total} HMMA instructions in {len(found)} instantiations")
    check(len(found) == 4, f"wkv6: {len(found)} instantiations of wkv6_chunked")
    return total


def wkv6_kernel_phase(torch, dev, randn) -> list:
    """The WKV6 recurrence against its plain version: rwkv6-7b's 64 heads of
    64 in bfloat16 for a served 512-token prompt from a zero state, a ragged
    97-token one and a batch of 8 x 4096 from a nonzero state, all with
    decays drawn as the JAX package's tests draw them ([0.45, 0.95]); the
    model's own decays (`wkv6_model_decays`: down to e^-54.6, exact zeros
    and ones) at 512 and a ragged 333 tokens from a nonzero state; and the
    reduced head size 32 in float32.  The bound counts each input and
    output once (bytes) against the chunked form's operations
    (`wkv6_operations`: its tensor-core products at the TF32 rate, its
    CUDA-core work at the float32 rate, the two overlapping); the plain
    loop's 5 K^2 float32 operations per (b, h, t) give ``fma_bound_ms``.
    T/64 chunk steps depend on each other."""
    from repro_torch.kernels import wkv6
    from repro_torch.kernels.rwkv6_wkv import wkv6_ref

    cases = [
        # name, B, T, H, K, dtype, nonzero initial state, model decays, reps
        ("served_512", 1, 512, 64, 64, torch.bfloat16, False, False, 10),
        ("ragged_97", 1, 97, 64, 64, torch.bfloat16, True, False, 10),
        ("long_4096", 8, 4096, 64, 64, torch.bfloat16, True, False, 3),
        ("decay_model_512", 1, 512, 64, 64, torch.bfloat16, True, True, 10),
        ("decay_model_333", 1, 333, 64, 64, torch.bfloat16, True, True, 10),
        ("small_f32", 2, 33, 8, 32, torch.float32, True, False, 10),
    ]
    gen = torch.Generator(device=dev).manual_seed(19)
    rows = []
    for name, b, t, h, kk, dtype, nonzero, model, reps in cases:
        r, k, v = randn(b, t, h, kk), randn(b, t, h, kk) * 0.3, randn(b, t, h, kk)
        w = (wkv6_model_decays(torch, gen, (b, t, h, kk), dev) if model
             else torch.sigmoid(randn(b, t, h, kk)) * 0.5 + 0.45)
        u = randn(h, kk) * 0.1
        r, k, v, w, u = (x.to(dtype) for x in (r, k, v, w, u))
        s0 = (randn(b, h, kk, kk) * 0.5 if nonzero
              else torch.zeros(b, h, kk, kk, device=dev))
        y, s = wkv6(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        ry, rs = wkv6_ref(r, k, v, w, u, s0)
        tname = str(dtype).removeprefix("torch.")
        a, ref = y.float(), ry.float()
        finite = bool(torch.isfinite(a).all()) and bool(torch.isfinite(s).all())
        y_err = float((a - ref).abs().max())
        y_use = float(((a - ref).abs() / (WKV_RTOL[tname] * ref.abs()
                                          + WKV_ATOL_SHARE * ref.abs().max())).max())
        s_err = float((s - rs).abs().max())
        s_use = float(((s - rs).abs() / (WKV_STATE_TOL * (1 + rs.abs()))).max())
        zeros, ones = int((w == 0).sum()), int((w == 1).sum())
        del y, s, ry, rs, a, ref
        sets = rotation((r, k, v, w, u, s0))
        ms, plain_ms, call_ms, plain_call_ms = kernel_and_plain_ms(
            torch, [lambda c=c: wkv6(*c) for c in sets],
            [lambda c=c: wkv6_ref(*c) for c in sets], reps)
        nbytes = 5 * b * t * h * kk * r.element_size() + u.numel() * u.element_size() \
            + 2 * b * h * kk * kk * 4
        tc, cc, steps = wkv6_operations(b, t, h, kk, dtype == torch.bfloat16)
        t_ops = max(tc / TF32_FLOPS_PER_S, cc / F32_FLOPS_PER_S)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, t_ops) * 1e3
        bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= t_ops else "operations"
        fma_bound_ms, fma_by = bound(nbytes, 5.0 * b * t * h * kk * kk)
        row = dict(shape=name, b=b, t=t, h=h, k=kk, dtype=tname,
                   nonzero_state=nonzero, model_decays=model, w_zeros=zeros, w_ones=ones,
                   max_abs_err=y_err, y_limit_use=y_use,
                   state_max_abs_err=s_err, state_limit_use=s_use, ms=ms,
                   call_ms=call_ms, plain_ms=plain_ms, plain_call_ms=plain_call_ms,
                   bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / ms,
                   tc_flops=tc, cuda_core_flops=cc, fma_bound_ms=fma_bound_ms,
                   fma_bound_by=fma_by, library_ms=None, chunk_steps=steps)
        rows.append(row)
        print(f"wkv6 {name:15s} B={b} T={t} H={h} K={kk} {tname}"
              f"{f' model decays ({zeros} zeros, {ones} ones)' if model else ''}: "
              f"y max_err={y_err:.3g} "
              f"({y_use:.3f} of the limit |a-b| <= {WKV_RTOL[tname]:.3g} |b| + "
              f"{WKV_ATOL_SHARE} max|b|), state max_err={s_err:.3g} ({s_use:.3f} of "
              f"{WKV_STATE_TOL} (1 + |b|)) ms={ms:.5f} call_ms={call_ms:.4f} "
              f"plain_ms={plain_ms:.4f} library: none bound_ms={bound_ms:.5f} "
              f"({bound_by}: {nbytes / 1e6:.1f} MB, {tc / 1e9:.3f} GFLOP on the tensor "
              f"cores, {cc / 1e9:.3f} on the CUDA cores; {bound_ms / ms:.1%} of it) "
              f"fma_bound_ms={fma_bound_ms:.5f} ({fma_by}) chunk steps T/64={steps}")
        check(finite, f"wkv6 {name}: non-finite output")
        check(y_use <= 1.0 and s_use <= 1.0,
              f"wkv6 {name}: y {y_use:.3g}, state {s_use:.3g} of their limits")
        del r, k, v, w, u, s0, sets
    return rows


def batch_width_diff(torch, np, engine, slots, dev, label, steps=4) -> tuple:
    """Does a slot batch's width change a request's numbers?  One request
    decoded ``steps`` greedy steps (the engine's decode step, MoE dropless)
    alone and as row 0 of a batch of ``slots`` (the other rows zero): the
    largest difference of its logits
    and of its cache leaves (for rwkv6 the recurrent state, which a decay
    that rounds the other way moves while the logits still agree), returned
    as (logits, cache)."""
    from repro_torch.models.param import tree_leaves

    cfg = engine.cfg
    p0 = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 200)).astype(np.int32)
    logits, cache = engine.prefill(p0)
    _, wide = engine.widen(logits, cache, slots)
    d_logits = 0.0
    for i in range(steps):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        tok_w = torch.zeros(slots, dtype=torch.int32, device=dev)
        tok_w[0] = tok[0]
        logits = engine.decode_step(cache, tok, p0.shape[1] + i)
        row0 = engine.decode_step(wide, tok_w, p0.shape[1] + i)[:1]
        d_logits = max(d_logits, float((logits - row0).abs().max()))
    d_cache = max(float((a.float() - b.narrow(ax, 0, 1).float()).abs().max())
                  for a, b, ax in zip(tree_leaves(cache), tree_leaves(wide),
                                      tree_leaves(engine.batch_axes)))
    print(f"{label}: {steps} decode steps alone vs as row 0 of batch {slots}: "
          f"largest logit difference {d_logits:.6g} (max |logit| "
          f"{float(logits.abs().max()):.4g}), largest cache difference {d_cache:.6g}")
    return d_logits, d_cache


def rwkv_small_phase(torch, np, dev) -> None:
    """The reduced float32 rwkv6 engine on the card against the same engine
    on the CPU, on the same weights: prefill logits, greedy tokens."""
    from repro_torch.kernels import wkv6
    from repro_torch.launch.serve import llm_config
    from repro_torch.serving import ServingEngine

    cfg = llm_config("rwkv6-7b", "small")
    cpu = ServingEngine(cfg, max_len=64, seed=0, device="cpu")
    card = ServingEngine(cfg, params=_to(torch, cpu.params, dev), max_len=64,
                         device=dev)
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    launches = wkv6.launches
    lc, lg = cpu.prefill(prompts)[0], card.prefill(prompts)[0].cpu()
    err = float((lc - lg).abs().max() / lc.abs().max())
    toks_cpu = cpu.generate(prompts, steps=16).tokens
    toks_card = card.generate(prompts, steps=16).tokens
    print(f"small rwkv6: {cfg.name} reduced float32, prefill logits card vs cpu "
          f"max_err/max|l|={err:.3g} (tol {LLM_SMALL_RTOL}); greedy tokens equal: "
          f"{bool(np.array_equal(toks_cpu, toks_card))}; wkv6 launches "
          f"{wkv6.launches - launches}")
    check(wkv6.launches - launches == 2 * cfg.num_layers,
          "the small rwkv6 run on the card did not launch wkv6 once per layer "
          "and prefill")
    check(err <= LLM_SMALL_RTOL, "small rwkv6: prefill logits differ from the CPU")
    check(np.array_equal(toks_cpu, toks_card), "small rwkv6: greedy tokens differ")


def rwkv_serving_phase(torch, np, dev) -> int:
    """rwkv6-7b at full width and depth in bfloat16 through the llm_disagg
    Workflow Set: 8 requests, prompts of 64 to 3000 tokens, 32 new tokens,
    half greedy and half at 0.7.  Returns the served run's wkv6 launches."""
    from repro_torch.kernels import (
        decode_attention_grouped,
        decode_attention_int8_grouped,
        flash_attention,
        wkv6,
    )
    from repro_torch.launch.serve import check_served, llm_config, llm_requests, serve
    from repro_torch.models import registry
    from repro_torch.serving import APP_LLM_DISAGG, ServingEngine, build_llm_disagg_set
    from repro_torch.serving.disagg import make_prefill_fn, ring_bytes_for

    attention = (flash_attention, decode_attention_grouped, decode_attention_int8_grouped)
    max_len, slots, segment, steps = 4096, 8, 8, 32
    cfg = llm_config("rwkv6-7b", "port")
    print(f"rwkv6: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
          f"before the engine")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, max_len=max_len, seed=0)
    torch.cuda.synchronize()
    print(f"rwkv6: {cfg.name} {cfg.num_layers} layers d_model {cfg.d_model} "
          f"{cfg.num_heads} WKV heads of {cfg.resolved_head_dim} d_ff {cfg.d_ff} "
          f"vocab {cfg.vocab_padded} in {cfg.dtype}: "
          f"{registry.count_params(cfg) / 1e9:.3f} B params on {engine.device} in "
          f"{time.perf_counter() - t0:.1f}s (peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB while drawing them); decode inbox "
          f"{ring_bytes_for(cfg, max_len, max_slots=slots) / 1e6:.1f} MB")

    batch_width_diff(torch, np, engine, slots, dev, "rwkv6")
    rng = np.random.default_rng(6)

    # the message a request ships does not grow with its prompt
    prefill_fn = make_prefill_fn(engine)
    sizes = {n: prefill_fn({"prompt": rng.integers(0, cfg.vocab_size, (1, n)).astype(
        np.int32), "steps": 1}).nbytes for n in (97, 3000)}
    print(f"rwkv6: state pages per request: {sizes[97]} B at 97 tokens, "
          f"{sizes[3000]} B at 3000")
    check(sizes[97] == sizes[3000], "rwkv6: the shipped state depends on the prompt")

    prompt_lens = [64, 512, 97, 256, 3000, 200, 1000, 384]
    reqs = llm_requests(cfg, rng, prompt_lens, steps, [0.0, 0.7])
    ws, decoder = build_llm_disagg_set(engine, name="rwkv6", max_slots=slots,
                                       segment_len=segment)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in (wkv6,) + attention:
        k.launches = 0
    outs, lost, wall = serve(ws, reqs, app=APP_LLM_DISAGG, batched=True)
    stats = ws.transport_stats()
    wk, att = wkv6.launches, sum(k.launches for k in attention)
    peak = torch.cuda.max_memory_allocated()
    print(f"serve rwkv6: {len(outs)}/{len(reqs)} answered, lost={lost}, "
          f"dropped={stats.dropped}, {wall:.2f}s wall, "
          f"{len(outs) * steps / wall:.1f} tokens/s, {stats.kv_pages} KVPages "
          f"{stats.kv_bytes / 1e6:.1f} MB ({stats.kv_bytes // max(stats.kv_pages, 1)} B "
          f"each), segments={decoder.stats['segments']} "
          f"max_resident={decoder.stats['max_resident']}/{slots}; launches "
          f"wkv6={wk} ({wk / len(reqs):.0f} per prefill), attention kernels={att}, "
          f"max_memory_allocated={peak / 2**30:.2f} GiB")
    check(lost == 0 and len(outs) == len(reqs), "rwkv6: requests lost")
    check(stats.dropped == 0, f"rwkv6: {stats.dropped} messages dropped")
    check(wk == cfg.num_layers * len(reqs), f"rwkv6: wkv6 launches {wk}")
    check(att == 0, f"rwkv6: {att} attention-kernel launches")
    check(stats.kv_bytes == len(reqs) * sizes[97], "rwkv6: shipped state size")

    for i, (r, out) in enumerate(zip(reqs, outs)):
        check(out.shape == (1, r["prompt"].shape[1] + steps),
              f"rwkv6: request {i} tokens of shape {out.shape}")
        for k in (wkv6,) + attention:
            k.launches = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        check_served(engine, [r], [out])     # raises if they differ
        dt = time.perf_counter() - t1
        print(f"  request {i}: prompt {r['prompt'].shape[1]} temperature "
              f"{r['temperature']}: solo generate {dt * 1e3:.1f} ms, launches "
              f"wkv6={wkv6.launches} attention={sum(k.launches for k in attention)}; "
              f"served tokens equal solo generate")
        check(wkv6.launches == cfg.num_layers and not any(k.launches for k in attention),
              f"rwkv6: request {i} solo generate launches")
    print("serve rwkv6: every request's tokens equal solo generate")
    del ws, decoder, engine
    return wk


#: whisper-large-v3 through ``ServingEngine.generate``: batches of
#: WHISPER_BATCH requests at each of these prompt lengths, WHISPER_STEPS new
#: greedy tokens, a self cache of the published 448-token decoder context
WHISPER_PROMPTS = [4, 64]
WHISPER_BATCH, WHISPER_MAX_LEN, WHISPER_STEPS = 4, 448, 64


def whisper_generate_phase(torch, np, dev) -> dict:
    """whisper-large-v3 at full width and depth in bfloat16 through
    ``ServingEngine.generate`` over the stub (zero) frames, as the JAX
    engine feeds them: its cache holds each request's cross K/V, so it has
    no slot batch (``init_slots`` raises, as the JAX engine's does).  A
    decode step's batch-1 against batch-4 differences 0; a batch of
    WHISPER_BATCH at each of `WHISPER_PROMPTS`, each row's tokens equal to
    that row's batch-1 ``generate``; flash launched once per
    encoder layer and twice per decoder layer (self, cross) a prefill,
    flash-decode twice per decoder layer a step (the self cache, and the
    cross cache at index 1499).  Returns the batched runs' launch counts."""
    from repro_torch.kernels import (
        decode_attention_grouped,
        decode_attention_int8_grouped,
        flash_attention,
    )
    from repro_torch.launch.serve import llm_config
    from repro_torch.models import registry
    from repro_torch.serving import ServingEngine

    kernels = (flash_attention, decode_attention_grouped, decode_attention_int8_grouped)
    b, steps = WHISPER_BATCH, WHISPER_STEPS
    cfg = llm_config("whisper-large-v3", "port")
    per_prefill, per_step = cfg.encoder_layers + 2 * cfg.num_layers, 2 * cfg.num_layers
    print(f"whisper: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
          f"before the engine")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, max_len=WHISPER_MAX_LEN, seed=0)
    torch.cuda.synchronize()
    cross = 2 * cfg.num_layers * cfg.resolved_kv_heads * cfg.frontend_tokens * \
        cfg.resolved_head_dim * 2
    self_kv = cross * WHISPER_MAX_LEN // cfg.frontend_tokens
    print(f"whisper: {cfg.name} {cfg.encoder_layers} encoder and {cfg.num_layers} decoder "
          f"layers d_model {cfg.d_model} {cfg.num_heads} heads of "
          f"{cfg.resolved_head_dim} d_ff {cfg.d_ff} vocab {cfg.vocab_padded} over "
          f"{cfg.frontend_tokens} stub frames in {cfg.dtype}: "
          f"{registry.count_params(cfg):,} params on {engine.device} in "
          f"{time.perf_counter() - t0:.1f}s (peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB while drawing them); "
          f"a request's cache: cross K/V {cross / 1e6:.2f} MB, self K/V "
          f"{self_kv / 1e6:.2f} MB at max_len {WHISPER_MAX_LEN}")
    try:
        engine.init_slots(1)
        fail("whisper: init_slots did not refuse the audio family")
    except NotImplementedError as e:
        print(f"whisper: init_slots refuses: {e}")
    d_logits, d_cache = batch_width_diff(torch, np, engine, b, dev, "whisper-large-v3")
    check(d_logits == 0 and d_cache == 0,
          f"whisper: a row decodes other numbers in a batch of {b} than alone "
          f"(logits {d_logits}, cache {d_cache})")
    rng = np.random.default_rng(7)
    counts = {"flash_attention": 0, "decode_attention_grouped": 0}
    for plen in WHISPER_PROMPTS:
        prompts = rng.integers(0, cfg.vocab_size, (b, plen)).astype(np.int32)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        engine.prefill(prompts)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t1) * 1e3
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        res = engine.generate(prompts, steps=steps)    # syncs: tokens to the host
        wall = time.perf_counter() - t1
        fl, dc = flash_attention.launches, decode_attention_grouped.launches
        i8 = decode_attention_int8_grouped.launches
        counts["flash_attention"] += fl
        counts["decode_attention_grouped"] += dc
        print(f"generate whisper-large-v3 B={b} prompt {plen}: {wall * 1e3:.1f} ms for "
              f"{steps} tokens a row ({b * steps / wall:.1f} tokens/s, "
              f"{(wall * 1e3 - prefill_ms) / steps:.2f} ms a decode step after a "
              f"{prefill_ms:.1f} ms prefill); launches flash={fl} ({per_prefill} a "
              f"prefill expected) decode={dc} ({dc / steps:.0f} per step), int8 "
              f"decode={i8}, max_memory_allocated="
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        check(fl == per_prefill and dc == per_step * steps and i8 == 0,
              f"whisper prompt {plen}: launches flash {fl}, decode {dc}, int8 {i8}")
        toks = res.tokens
        check(toks.shape == (b, plen + steps) and np.array_equal(toks[:, :plen], prompts)
              and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
              f"whisper prompt {plen}: tokens {toks.shape} out of shape or range")
        for i in range(b):
            solo = engine.generate(prompts[i:i + 1], steps=steps).tokens
            check(np.array_equal(solo, toks[i:i + 1]),
                  f"whisper prompt {plen}: row {i} differs from its batch-1 generate")
        print(f"generate whisper-large-v3 prompt {plen}: every row's tokens equal its "
              f"batch-1 generate ({len(set(map(tuple, toks[:, plen:].tolist())))} "
              f"distinct rows)")
    del engine
    return counts


#: The flash backward kernel's cases (``flash_attention_bwd.cu``): name ->
#: ((B, Sq, Sk, H, KV, D), causal, dtype, repetitions).  qwen3-1.7b's layer
#: at the training run's B 4, S 256 (16 query heads over 8); zamba2-1.2b's
#: shared block (32/32 heads of 64, causal); whisper-large-v3's
#: cross-attention, 64 decoder tokens over the 1500 frames; qwen3-1.7b's
#: heads at 4096 causal tokens, where the tensor core's truncated sums over
#: 64 query tiles bias the bfloat16 kernel most; a band of the Wan DiT's
#: float32 self-attention (40 heads of 128, 2048 of its 18,900 tokens),
#: standing in for ``diffusion_loss``'s gradient; the launcher's float32
#: ``100m`` preset at the smoke's B 4, S 256 (8 heads of 64 over 4), the
#: float32 kernel's shape in `train_run` (`TRAIN_F32_ARGS`); the DiT's whole
#: self-attention, all 18,900 tokens, at 2 of its 40 heads (the plain
#: version chunks its query rows, so it fits); the DiT's text
#: cross-attention, all 18,900 tokens and 40 heads over the 512 text keys
#: (``diffusion_loss``'s, float32 with Sq != Sk); whisper-large-v3's encoder
#: self-attention at the training batch of 4 (1500 frames: a ragged last
#: tile of 28 rows and keys); then the training shapes of the families
#: trained at a cut depth (B 4 x S 256, causal, heads of 128), whose query
#: groups a dK/dV block loops over: chatglm3-6b 32 heads over 2 (groups of
#: 16), deepseek-67b 64 over 8 (8), gemma3-27b 32 over 16 (2), and
#: deepseek-moe-16b 16 over 16 (1).
TRAIN_BWD_CASES = [
    ("qwen3_train_4x256", (4, 256, 256, 16, 8, 128), True, "bfloat16", 10),
    ("zamba2_train_512", (1, 512, 512, 32, 32, 64), True, "bfloat16", 10),
    ("whisper_cross_64x1500", (1, 64, 1500, 20, 20, 64), False, "bfloat16", 10),
    ("qwen3_long_4096", (1, 4096, 4096, 16, 8, 128), True, "bfloat16", 3),
    ("dit_band_2048", (1, 2048, 2048, 40, 40, 128), False, "float32", 3),
    ("qwen3_100m_4x256", (4, 256, 256, 8, 4, 64), True, "float32", 10),
    ("dit_self_18900_2h", (1, 18900, 18900, 2, 2, 128), False, "float32", 3),
    ("dit_cross_18900x512", (1, 18900, 512, 40, 40, 128), False, "float32", 3),
    ("whisper_enc_1500", (4, 1500, 1500, 20, 20, 64), False, "bfloat16", 5),
    ("qwen3_train_4x256_v128", (4, 256, 256, 16, 8, 128), True, "bfloat16", 10),
    ("zamba2_train_512_v128", (1, 512, 512, 32, 32, 64), True, "bfloat16", 10),
    ("chatglm3_train_4x256", (4, 256, 256, 32, 2, 128), True, "bfloat16", 10),
    ("deepseek67b_train_4x256", (4, 256, 256, 64, 8, 128), True, "bfloat16", 10),
    ("gemma3_train_4x256", (4, 256, 256, 32, 16, 128), True, "bfloat16", 10),
    ("deepseek_moe_train_4x256", (4, 256, 256, 16, 16, 128), True, "bfloat16", 10),
]
#: The full-width gradient check: qwen3-1.7b at 2 of its 28 layers, one
#: loss and gradient with the flash kernels against the same with the
#: attention's forward and backward patched to their plain versions, on the
#: same bfloat16 weights and batch.  Both compute attention in float32 and
#: round each output once to bfloat16, so an element of o, dq, dk or dv may
#: round one step apart; downstream every weight gradient is a bfloat16
#: product summed over the batch's 1,024 tokens, which moves an element by
#: a few bfloat16 steps of its leaf's largest.  Each leaf is held to
#: max|a - b| <= GRAD_CHECK_SHARE max|b| (a missing or wrong gradient is
#: off by its whole size), the loss to GRAD_CHECK_LOSS_RTOL.
GRAD_CHECK_LAYERS = 2
GRAD_CHECK_SHARE = 2 ** -5
GRAD_CHECK_LOSS_RTOL = 1e-3
#: The float32 path of the backward: the launcher's default ``100m`` preset
#: (a 12-layer qwen3 of width 512, float32), 3 steps.
TRAIN_F32_ARGS = ["--arch", "qwen3-1.7b", "--preset", "100m", "--steps", "3",
                  "--batch", "4", "--seq", "256", "--log-every", "1", "--lr", "1e-3",
                  "--data-vocab", "1024"]
#: The full run: qwen3-1.7b at full width and depth through
#: ``launch.train``, AdamW at lr 1e-3, B 4 x S 256 tokens of the bigram data
#: drawn from the first 1,024 ids (the model keeps all 151,936): over the
#: whole vocabulary a batch almost never repeats a token and 8 steps learn
#: nothing (lr 3e-4: ce 11.9628 -> 11.9570, inside the batches' noise).
TRAIN_ARGS = ["--arch", "qwen3-1.7b", "--preset", "full", "--steps", "8",
              "--batch", "4", "--seq", "256", "--log-every", "1", "--lr", "1e-3",
              "--data-vocab", "1024"]
#: The families that had not trained on the card before: whisper-large-v3
#: (32 encoder and 32 decoder layers; the launcher feeds zero frames, as the
#: JAX launcher does), zamba2-1.2b (38 Mamba2 layers, the shared block at
#: 6 places), internvl2-1b (24 layers; the launcher draws its patch
#: embeddings over the first 256 positions, all of S 256) and
#: granite-moe-3b-a800m (32 MoE layers, dropless, as the launcher trains
#: them), each at full width and depth through ``launch.train``, 4 AdamW
#: steps of the bigram chain as `TRAIN_ARGS`.
FAMILY_TRAIN_ARGS = {
    arch: ["--arch", arch, "--preset", "full", "--steps", "4", "--batch", "4", "--seq",
           "256", "--log-every", "1", "--lr", "1e-3", "--data-vocab", "1024"]
    for arch in ("whisper-large-v3", "zamba2-1.2b", "internvl2-1b", "granite-moe-3b-a800m")}
#: The families that one card cannot train at full depth: every width, the
#: depth cut to the layers below, FAMILY_TRAIN_STEPS AdamW steps through
#: ``make_train_step`` (`train_steps`; the launcher has no depth flag, as
#: the JAX launcher has none) of the bigram chain as `TRAIN_ARGS`.
#: Reckoned by ``registry.abstract_params`` at 12 bytes a parameter
#: (bfloat16 weights and gradients, float32 moments), which must leave
#: room in the card's 80 GB for the activations and the per-layer
#: gradients autograd holds until it stacks them (on an H100 the peaks
#: stood 1.4-2.6 GiB above the reckoning): chatglm3-6b 24 of 28 layers:
#: 5.428 B parameters, 60.7 GiB (whole, 6.243 B and 69.8 GiB, it peaked at
#: 72.84 GiB in its first step on an H100 and ran out of memory in the
#: second, asking 2.93 GiB, its stacked w_down gradient, with 7.16 GiB
#: reserved but free in pieces); gemma3-27b 6 of 62, one period of (5
#: local, 1 global), the fewest layers that reach a flash kernel: 5.296 B,
#: 59.2 GiB, its embedding and unembedding 1.409 B each; deepseek-moe-16b 8
#: of 28, dense layer 0 and 7 MoE layers (dropless, as the launcher trains
#: them): 4.620 B, 51.6 GiB; deepseek-67b 5 of 95: 5.138 B, 57.4 GiB, each
#: layer 0.692 B or 7.73 GiB.
FAMILY_TRAIN_DEPTHS = {"chatglm3-6b": 24, "gemma3-27b": 6, "deepseek-moe-16b": 8,
                       "deepseek-67b": 5}
FAMILY_TRAIN_STEPS = 4
#: The gradient checks of those families at full width (B 4 x S 256,
#: bfloat16, at qwen3's limits): name -> (arch, depth overrides).
#: whisper at 2 encoder and 2 decoder layers over 1500 random frames (zero
#: frames, the launcher's, leave the encoder's attention and the
#: cross-attention without a signal); zamba2 at one period of its
#: ``hybrid_attn_every`` = 6 Mamba2 layers, so the shared block runs once;
#: internvl2 and granite at 2 layers, internvl2 with random patch
#: embeddings, granite dropless and held against a yardstick (below).
#:
#: The weights of the gradient checks.  The init rule draws a stacked leaf
#: [L, ...] with fan_in = shape[0], the layer count, so at full width Wan's
#: and whisper's scores reach thousands and the softmax is one-hot: there
#: the gradient is a difference of near-equal terms, and one float32 step
#: of the plain attention's output alone moves a leaf by its whole size.
#: No two float32 orders of the same sums meet a fixed limit there.  So the
#: end-to-end comparison of Wan, whisper and zamba2 (`grad_check`, always
#: held at fixed limits) runs on the same draws rescaled to std
#: 1/sqrt(fan-in) (`fan_in_weights`, as the CPU parity tests draw weights),
#: and the one-hot regime of the rule's weights is held where it is
#: decided, at each flash call, against float64 (`init_attention_check`).
#: qwen3 normalises its queries and keys, so its check keeps the rule's
#: weights.  rwkv6's check (`RWKV_GRAD_PAIRS`) keeps them too, and holds its
#: bfloat16 pairs against the plain loop to twice a yardstick taken in the
#: same run, because on those weights its yardstick (the plain loop's y
#: moved as another order of its float32 sums moves it) already moves the
#: worst leaf past 2^-5: a fixed limit there would fail on rounding alone.
#: granite's (and any dropless MoE's) end-to-end check does the same with
#: the attention's output so moved (`grad_check`'s ``yardstick``): its
#: top-8 routing of 40 experts sends a token to another expert where a
#: rounding of the attention moves two router logits past each other.
#:
#: The families trained at a cut depth (`FAMILY_TRAIN_DEPTHS`): chatglm3,
#: deepseek-moe (its dense layer 0 and one MoE layer, dropless, with the
#: routing yardstick: top-6 of 64 experts) and deepseek-67b at 2 layers;
#: gemma3 at 6, one period of its (5 local, 1 global) pattern, since only
#: the sixth, global, layer reaches the flash kernels.
FAMILY_GRAD_CHECKS = {
    "whisper": ("whisper-large-v3", dict(num_layers=2, encoder_layers=2)),
    "zamba2": ("zamba2-1.2b", dict(num_layers=6)),
    "internvl2": ("internvl2-1b", dict(num_layers=2)),
    "granite": ("granite-moe-3b-a800m", dict(num_layers=2)),
    "chatglm3": ("chatglm3-6b", dict(num_layers=2)),
    "gemma3": ("gemma3-27b", dict(num_layers=6)),
    "deepseek_moe": ("deepseek-moe-16b", dict(num_layers=2)),
    "deepseek67b": ("deepseek-67b", dict(num_layers=2)),
}
#: The families whose flash calls on the init rule's weights are held at
#: the elementwise limit from float64 too (`init_attention_check`): qwen3
#: and gemma3 (their queries and keys normalised) and zamba2, whose scores
#: stay near 5 there.  The others are one-hot there (scores 1.0e4-2.2e4 for
#: chatglm3, deepseek-moe and deepseek-67b) and held at ONE_HOT_SHARE only.
#: gemma3's one flash call at 6 layers read, on an H100, scores up to 5.09
#: and a row's largest softmax weight 0.097 on average, the kernels' o, dq,
#: dk, dv 0.498, 0.691, 0.498, 0.495 of the limit from float64 (the plain
#: path's dq 1.61): qwen3's regime.  At another draw of weights and tokens
#: (`scripts/grad_check_seeds.py`, seed 1) its dq read 1.043 of that limit,
#: the plain path's 1.574: the float32 sums, not the bfloat16 terms.
ELEMENTWISE_INIT_FAMILIES = ("qwen3-1.7b", "zamba2-1.2b", "gemma3-27b")
#: The families whose end-to-end check (`family_grad_check`) keeps the init
#: rule's weights, where their normalised queries and keys keep the
#: softmax spread: qwen3 and gemma3 (whose end-to-end check there read a
#: worst leaf of 0.0135 on an H100).  The others run it on the fan-in
#: weights (`fan_in_weights`).
RULE_WEIGHTS_FAMILIES = ("qwen3-1.7b", "gemma3-27b")
#: Wan's training objective at ``PORT`` (2 DiT layers, every width), float32:
#: ``diffusion_loss`` through the float32 flash kernels against the same
#: under `plain_attention`, the loss within WAN_LOSS_RTOL relative and each
#: leaf within WAN_GRAD_SHARE of its largest element.  The kernels hold
#: their outputs to 2e-5 and every product outside them runs in full
#: float32 (TF32 off), so 1e-4 leaves room for the sums over 18,900 rows.
#: The same limits hold ``vae_loss`` on the card against the port on the
#: CPU (VAE_FRAMES 480 x 480 frames: a cut of the batch, not of a width).
#: The flash calls of one kernel run on the init rule's weights
#: (`init_attention_check`): each of o, dq, dk and dv within ONE_HOT_SHARE
#: of its largest element from the float64 result.  With scores in the
#: thousands the kernel phase's elementwise limits are out of reach of any
#: float32 computation: the plain path itself lies many times past them
#: from float64 there.  One bfloat16 step of the largest element bounds what
#: rounding leaves: a bfloat16 output's own rounding (2^-9) and, in both
#: backwards, P recomputed from the forward's log-sum-exp with the
#: backward's own scores, which a score's rounding at |s| ~ 1e4 moves by
#: ~|s| 2^-22 ~ 2^-8.7.
ONE_HOT_SHARE = 2 ** -7
WAN_LOSS_RTOL = 1e-5
WAN_GRAD_SHARE = 1e-4
VAE_FRAMES = 2
#: Seeds of the checks' inputs (weights from generator 0)
INPUT_SEED = 1


def flash_bwd_build_report(lib_path) -> dict:
    """The backward kernels' builds, bfloat16 (``flash_attention_bwd_bf16.cu``)
    and float32 (``flash_attention_bwd.cu``, 3xTF32): the 3 instantiations
    of each one's main kernel on the tensor cores (dK, dV and dQ blocks in
    one launch, at three head sizes), each with its warpgroup MMAs (HGMMA)
    in the SASS, its registers and spills; fails at 0 HGMMA in a main
    kernel or at a spill, also of its pre-pass and combine."""
    import re

    out = {}
    for dt in ("bf16", "f32"):
        found = {}
        for name, r in sass_report(lib_path, f"flash_bwd_{dt}", "HGMMA").items():
            m = re.search(rf"\d(flash_bwd_{dt}_[a-z]+)(?:ILi(\d+)E)?", name)
            found[m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")] = r
        wgmma = 0
        for label, r in sorted(found.items()):
            on_tc = "_main<" in label
            wgmma += on_tc
            print(f"flash bwd {dt} build: {label}: HGMMA {r['count']}, registers "
                  f"{r.get('registers')}, spill stores/loads {r.get('spill')} bytes; "
                  f"ptxas on wgmma: {r.get('wgmma_notes', 'nothing')}")
            check(not on_tc or r["count"] > 0, f"flash bwd {dt}: no HGMMA in {label}")
            check(r.get("spill", (0, 0)) == (0, 0), f"flash bwd {dt}: {label} spills")
        check(wgmma == 3, f"flash bwd {dt}: {wgmma} instantiations on the tensor cores, "
                          f"expected 3")
        hgmma = sum(r["count"] for r in found.values())
        print(f"flash bwd {dt} build: {hgmma} HGMMA instructions in {wgmma} instantiations")
        out[dt] = {"hgmma": hgmma,
                   "registers": {k: r.get("registers") for k, r in found.items()}}
    return out


def sdpa_backward_ms(torch, F, q, k, v, do, causal: bool, reps: int) -> float:
    """Device ms of SDPA's backward alone on these inputs ([B,S,H,D] here,
    [B,H,S,D] for SDPA), by ``torch.profiler``: the summed device time of
    the kernels that ``reps`` gradient calls launch, over ``reps``."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile

    h, kv = q.shape[2], k.shape[2]
    dos = do.transpose(1, 2)
    backends = ([SDPBackend.EFFICIENT_ATTENTION] if q.dtype == torch.float32
                else [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION])
    for expand in (False, True):
        # grouped heads natively if a fused backend takes them, else K and V
        # repeated to every query head before the call
        g = h // kv if expand else 1
        qs, ks, vs = (x.transpose(1, 2).repeat_interleave(g if x is not q else 1, dim=1)
                      .detach().requires_grad_() for x in (q, k, v))
        try:
            with sdpa_kernel(backends):
                out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                                     enable_gqa=h != kv and not expand)
                torch.autograd.grad(out, (qs, ks, vs), dos, retain_graph=True)  # warm-up
            break
        except RuntimeError as e:
            check(not expand and h != kv, f"sdpa backward: {e}")
            print(f"sdpa backward: no fused backend takes {h} over {kv} heads; "
                  f"K and V repeated")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            torch.autograd.grad(out, (qs, ks, vs), dos, retain_graph=True)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type.name == "CUDA")
    check(us > 0, "sdpa backward: the profiler saw no device time")
    return us / 1e3 / reps


def kernel_split_ms(torch, fn, reps: int, prefix: str) -> dict:
    """Device ms per call of each kernel whose name holds ``prefix``, over
    ``reps`` calls of ``fn`` under ``torch.profiler`` (by the kernel's name
    after the prefix, e.g. ``kv<128>``)."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(re.escape(prefix) + r"(\w+(?:<\d+>)?)", e.key)
        if e.device_type.name == "CUDA" and m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + e.self_device_time_total / 1e3 / reps
    check(len(out) > 0, f"the profiler saw no {prefix} kernel")
    return out


def bf16_steps(torch, ours, exact) -> dict:
    """Each of dq, dk, dv against the float32 gradient of the same bfloat16
    inputs, in bfloat16 steps of the exact value, over the elements above
    1e-3 of its largest: -> name -> (largest distance, mean signed distance
    along the exact value's sign).  A negative mean is a bias toward zero,
    as the tensor core's truncated sums into its accumulator give."""
    out = {}
    for name, a, e in zip(("dq", "dk", "dv"), ours, exact):
        big = e.abs() > 1e-3 * float(e.abs().max())
        step = torch.exp2(torch.floor(torch.log2(e.abs().clamp_min(1e-30))) - 7)
        dist = ((a.float() - e) / step)[big]
        out[name] = (float(dist.abs().max()), float((dist * e.sign()[big]).mean()))
    return out


def lse_store_cost(torch, q, k, v, causal: bool) -> dict:
    """The forward (either type) at these inputs with and without its
    log-sum-exp store: the same bits of o, the stored lse's largest share
    of the limit 2e-5 (1 + |b|) against ``attention_ref``'s, and the time of
    each, in turns (without, with, with, without): device ms
    (`device_ms`) where a call takes under DEVICE_TIME_BELOW_MS, else the
    median of 3 single calls between events."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import attention_ref, flash_attention_with_lse

    with torch.no_grad():
        o = flash_attention(q, k, v, causal=causal)
    o_lse, lse = flash_attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    check(torch.equal(o, o_lse), "flash: o differs with the log-sum-exp store")
    del o, o_lse
    _, ref = attention_ref(q, k, v, causal=causal, return_lse=True)
    _, use = limit_errs(lse, ref, 2e-5, 2e-5)
    check(use <= 1.0, f"flash: the stored log-sum-exp is {use} of its limit")
    del lse, ref
    sets = rotation((q, k, v))
    off = [lambda c=c: flash_attention(*c, causal=causal) for c in sets]
    on = [lambda c=c: flash_attention_with_lse(*c, causal=causal) for c in sets]
    with torch.no_grad():
        fast = statistics.median(cuda_times(torch, off[0], 3)) < DEVICE_TIME_BELOW_MS
        time_it = ((lambda f: device_ms(torch, f)) if fast
                   else (lambda f: statistics.median(cuda_times(torch, f[0], 3))))
        t = [time_it(f) for f in (off, on, on, off)]
    ms_off, ms_on = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    return dict(ms_without=ms_off, ms_with=ms_on, cost=ms_on / ms_off - 1, runs_ms=t,
                timed_by="device_ms" if fast else "single calls", lse_limit_use=use)


def flash_bwd_kernel_phase(torch, F, dev, randn, names=None) -> list:
    """The backward kernels against ``attention_bwd_ref`` (recomputing the
    softmax) on the forward kernel's output (bfloat16 within one bfloat16
    step, from the log-sum-exp the forward kernel stores; float32 to its f32
    limit; element by element over dq, dk and dv), their time beside the
    plain version's and SDPA's backward, and their bound: 10 Sq Sk D flops a
    head (half of it causal) at the bfloat16 tensor-core rate, or for
    float32 as three TF32 products (the FMA bound beside it), against the
    bytes of q, k, v, o, dO, dq, dk and dv read or written once; a call's
    device ms by kernel (pre-pass, main, combine).  At qwen3-1.7b's training
    shape, the bfloat16 forward's time with and without the log-sum-exp
    store (`lse_store_cost`).  `FROM_F64_CASES` are held from the float64
    gradient (`attention_f64`, given the kernel's o), the kernels'
    arithmetic emulated beside (`split_readings`).  ``names``: those cases
    only."""
    from repro_torch.kernels import flash_attention_backward
    from repro_torch.kernels.flash_attention import attention_bwd_ref, flash_attention_with_lse

    rows = []
    for name, (b, sq, sk, h, kv, d), causal, dt, reps in TRAIN_BWD_CASES:
        if names is not None and name not in names:
            continue
        dtype = getattr(torch, dt)
        if name in FROM_F64_CASES:
            q, k, v, do = from_f64_inputs(torch, dev, b, sq, sk, h, kv, d)
        else:
            q, do = (randn(b, sq, h, d).to(dtype) for _ in range(2))
            k, v = (randn(b, sk, kv, d).to(dtype) for _ in range(2))
        o, lse = flash_attention_with_lse(q, k, v, causal=causal)
        ours = flash_attention_backward(q, k, v, o, do, causal=causal, lse=lse)
        torch.cuda.synchronize()
        ref = attention_bwd_ref(q, k, v, o, do, causal=causal)
        tol = (BF16_ATOL, BF16_RTOL) if dt == "bfloat16" else (F32_ATOL, F32_RTOL)
        errs = [limit_errs(a, r, *tol) for a, r in zip(ours, ref)]
        err, use = max(e[0] for e in errs), max(e[1] for e in errs)
        against, emulated = "", None
        if name in FROM_F64_CASES:
            exact, mags = attention_f64(torch, q, k, v, o, do, causal, d ** -0.5,
                                        magnitudes=True)
            floors = [F32_TERM_STEPS * 2.0 ** -24 * m for m in mags]
            names4 = ("o", "dq", "dk", "dv")
            plain_use = max(limit_errs(a, e, floor=f)[1]
                            for a, e, f in zip(ref, exact[1:], floors[1:]))
            bare = {n: limit_errs(a, e)[1] for n, a, e in zip(names4, (o, *ours), exact)}
            kernel = {n: limit_errs(a, e, floor=f)[1]
                      for n, a, e, f in zip(names4, (o, *ours), exact, floors)}
            errs = [limit_errs(a, e, floor=f) for a, e, f in zip(ours, exact[1:], floors[1:])]
            against = (f" from float64, with {F32_TERM_STEPS:g} float32 step of its terms; "
                       f"the bare limit dq {bare['dq']:.3f} dk {bare['dk']:.3f} dv "
                       f"{bare['dv']:.3f}; against the plain version {use:.3f}; the plain "
                       f"version from float64 {plain_use:.3f}")
            err, use = max(e[0] for e in errs), max(e[1] for e in errs)
            emulated = split_readings(torch, q, k, v, o, do, lse, causal, d ** -0.5, exact,
                                      floors)
            print_split_readings(f"flash bwd {name} (with {F32_TERM_STEPS:g} float32 step "
                                 f"of the terms)", kernel, emulated)
            emulated["kernel_bare"] = bare
            del exact, mags, floors
        steps = (bf16_steps(torch, ours, attention_bwd_ref(
            *(x.float() for x in (q, k, v, o, do)), causal=causal))
            if dt == "bfloat16" else None)
        del ours, ref
        sets = rotation((q, k, v, o, do, lse))
        ms, plain_ms, call_ms, plain_call_ms = kernel_and_plain_ms(
            torch, [lambda c=c: flash_attention_backward(*c[:5], causal=causal, lse=c[5])
                    for c in sets],
            [lambda c=c: attention_bwd_ref(*c[:5], causal=causal) for c in sets], reps)
        library_ms = sdpa_backward_ms(torch, F, q, k, v, do, causal, reps)
        elem = 2 if dt == "bfloat16" else 4
        nbytes = elem * (4 * b * sq * h * d + 4 * b * sk * kv * d)
        flops = 10.0 * b * h * sq * sk * d * (0.5 if causal else 1.0)
        if dt == "bfloat16":
            bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
            fma_bound_ms = bound(nbytes, flops)[0]
        else:
            bound_ms, bound_by = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
            fma_bound_ms = bound(nbytes, flops)[0]
        row = dict(shape=name, q=[b, sq, h, d], kv=[b, sk, kv, d], causal=causal,
                   dtype=dt, max_abs_err=err, limit_use=use, ms=ms, call_ms=call_ms,
                   plain_ms=plain_ms, plain_call_ms=plain_call_ms, bound_ms=bound_ms,
                   bound_by=bound_by, fma_bound_ms=fma_bound_ms, library_ms=library_ms,
                   vs_library=ms / library_ms, bound_share=bound_ms / ms,
                   steps_from_f32=steps, emulated=emulated,
                   held_from="float64" if name in FROM_F64_CASES else "plain")
        rows.append(row)
        print(f"flash bwd {name} q={row['q']} kv={row['kv']} {dt} causal={causal}: "
              f"max_err={err:.3g} ({use:.3f} of the {dt} limit{against}) ms={ms:.4f} "
              f"call_ms={call_ms:.4f} plain_ms={plain_ms:.4f} "
              f"sdpa_bwd_ms={library_ms:.4f} (kernel/sdpa {ms / library_ms:.2f}x) "
              f"bound_ms={bound_ms:.4f} ({bound_by}; {bound_ms / ms:.1%} of it) "
              f"fma_bound_ms={fma_bound_ms:.4f}")
        check(use <= 1.0, f"flash bwd {name}: max_err {err}, {use} of the {dt} limit")
        if dt == "bfloat16":
            print(f"flash bwd {name} from the float32 gradient, in bfloat16 steps: "
                  + ", ".join(f"{t} at most {m:.3f}, mean along its sign {b:+.4f}"
                              for t, (m, b) in steps.items()))
        prefix = "flash_bwd_bf16_" if dt == "bfloat16" else "flash_bwd_f32_"
        row["kernels_ms"] = split = kernel_split_ms(
            torch, lambda: flash_attention_backward(q, k, v, o, do, causal=causal, lse=lse),
            reps, prefix)
        print(f"flash bwd {name} by kernel (torch.profiler, device ms a call): "
              + ", ".join(f"{kk} {vv:.4f}" for kk, vv in split.items())
              + f"; sum {sum(split.values()):.4f}")
        if name == "qwen3_train_4x256":
            row["forward_lse_store"] = c = lse_store_cost(torch, q, k, v, causal)
            print(f"flash fwd {name} bf16 causal={causal}: without the log-sum-exp store "
                  f"ms={c['ms_without']:.4f}, with it ms={c['ms_with']:.4f} "
                  f"({c['cost']:+.1%}; {c['timed_by']}); o equal bit for bit")
        del q, k, v, o, do, lse, sets
    return rows


#: The WKV6 backward's cases (``wkv6_bwd_kernel_phase``): rwkv6-7b's
#: training shape (64 heads of 64, B 4 x 256, bfloat16), the launcher's
#: float32 ``100m`` preset (8 heads of 64), and the forward phase's ragged,
#: long, model-decay and reduced-head cases: (name, B, T, H, K, dtype,
#: nonzero initial state and final-state gradient, model decays, reps).
WKV_BWD_CASES = [
    ("rwkv6_train_4x256", 4, 256, 64, 64, "bfloat16", False, False, 5),
    ("rwkv6_100m_4x256", 4, 256, 8, 64, "float32", True, False, 5),
    ("ragged_97", 1, 97, 64, 64, "bfloat16", True, False, 5),
    ("long_4096", 8, 4096, 64, 64, "bfloat16", True, False, 3),
    ("decay_model_333", 1, 333, 64, 64, "bfloat16", True, True, 5),
    ("small_f32", 2, 33, 8, 32, "float32", True, False, 10),
]
#: The WKV6 backward against ``wkv6_bwd_ref``, element by element on each
#: of dr, dk, dv, dw, du and dstate, as |a - b| <= rtol |b| + atol + share
#: max|b| with (rtol, atol, share): float32 (and dstate, float32 at either
#: input type) within 2e-5 of the output's largest element, (0, 0, 2e-5),
#: since both sum in float32 in another order; bfloat16 one bfloat16 step,
#: (2^-7, 1e-5, 0), since both round the same float32 gradient once.
WKV_BWD_TOL = {"float32": (0.0, 0.0, 2e-5), "bfloat16": (2 ** -7, 1e-5, 0.0)}
#: rwkv6-7b at full width trained through ``make_train_step``: depth cut to
#: RWKV_TRAIN_LAYERS of 32 (~218 M parameters a layer and 0.54 B of
#: embeddings: bfloat16 weights and gradients and float32 moments come to
#: ~48 GB at 16 layers, ~91 GB whole), RWKV_TRAIN_STEPS AdamW steps at lr
#: 1e-3 of B 4 x S 256 tokens of the bigram chain over 1,024 ids.
RWKV_TRAIN_LAYERS = 16
RWKV_TRAIN_STEPS = 6
#: Steps after those, under ``torch.profiler`` (`profile_steps`), for
#: where a step's device time goes; their launches are not counted.
PROFILED_STEPS = 2
#: The launcher's float32 path for rwkv6: the ``100m`` preset (12 layers of
#: width 512, 8 heads of 64), as the JAX launcher's own preset trains it.
RWKV_TRAIN_F32_ARGS = ["--arch", "rwkv6-7b", "--preset", "100m", "--steps", "3",
                       "--batch", "4", "--seq", "256", "--log-every", "1", "--lr", "1e-3",
                       "--data-vocab", "1024"]


def wkv6_bwd_build_report(lib_path) -> dict:
    """The WKV6 backward's build (``wkv6_bwd.cu``): each instantiation of
    its main kernel (input type, K) with the tensor-core instructions (HMMA,
    from mma.sync) in its SASS, its registers and spills from ptxas, and its
    launch as the card takes it (``repro_wkv6_bwd_occupancy``: dynamic
    shared memory, threads and blocks an SM); the combine kernel's
    registers.  Fails at a spill, or at a main kernel without HMMA."""
    import ctypes
    import re

    from repro_torch.kernels import _build

    out = {}
    for name, r in sorted(sass_report(lib_path, "wkv6_bwd", "HMMA").items()):
        kind = "main" if "wkv6_bwd_main" in name else "combine"
        dt = "bfloat16" if "nv_bfloat16" in name else "float32"
        m = re.search(r"Li(\d+)E", name)
        label = f"wkv6_bwd_{kind}<{dt}{', K=' + m.group(1) if m else ''}>"
        row = dict(registers=r.get("registers"), hmma=r["count"], spill=r.get("spill"))
        launch = ""
        if kind == "main":
            occ = (ctypes.c_int * 4)()
            _build.check(_build.library().repro_wkv6_bwd_occupancy(
                int(dt == "bfloat16"), int(m.group(1)), occ), "wkv6_bwd occupancy")
            row.update(smem_bytes=occ[0], threads=occ[1], blocks_per_sm=occ[3])
            launch = (f", {occ[1]} threads, {occ[0]} bytes of shared memory, "
                      f"{occ[3]} block(s) an SM")
            check(r["count"] > 0, f"wkv6 bwd: no HMMA in {label}")
            check(occ[3] >= 1, f"wkv6 bwd: {label} does not fit on an SM")
        out[label] = row
        print(f"wkv6 bwd build: {label}: HMMA {r['count']}, registers {r.get('registers')}, "
              f"spill stores/loads {r.get('spill')} bytes{launch}")
        check(r.get("spill", (0, 0)) == (0, 0), f"wkv6 bwd: {label} spills")
    print(f"wkv6 bwd build: {sum(v['hmma'] for v in out.values())} HMMA instructions in "
          f"{len(out)} instantiations")
    check(len(out) == 6, f"wkv6 bwd: {len(out)} instantiations, expected 6")
    return out


def wkv6_bwd_inputs(torch, dev, gen, b, t, h, kk, dt, nonzero, model):
    """One case's inputs (`WKV_BWD_CASES`) from ``gen``: r, v, dy N(0, 1), k
    N(0, 0.3^2), u N(0, 0.1^2), w in [0.45, 0.95] or the model's decays
    (`wkv6_model_decays`), in the case's type; where ``nonzero`` an initial
    state N(0, 0.5^2) and a final-state gradient N(0, 1), else zeros and
    None.  -> (r, k, v, w, u, s0, dy, ds)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    dtype = getattr(torch, dt)
    r, k, v, dy = randn(b, t, h, kk), randn(b, t, h, kk) * 0.3, randn(b, t, h, kk), \
        randn(b, t, h, kk)
    w = (wkv6_model_decays(torch, gen, (b, t, h, kk), dev) if model
         else torch.sigmoid(randn(b, t, h, kk)) * 0.5 + 0.45)
    u = randn(h, kk) * 0.1
    r, k, v, w, u, dy = (x.to(dtype) for x in (r, k, v, w, u, dy))
    s0 = randn(b, h, kk, kk) * 0.5 if nonzero else torch.zeros(b, h, kk, kk, device=dev)
    ds = randn(b, h, kk, kk) if nonzero else None
    return r, k, v, w, u, s0, dy, ds


def wkv6_bwd_kernel_phase(torch, dev) -> list:
    """The WKV6 backward against ``wkv6_bwd_ref`` (`WKV_BWD_CASES`, inputs
    `wkv6_bwd_inputs`, limits `WKV_BWD_TOL`): the gradients autograd takes
    through ``wkv6`` (one forward and one backward launch) with every input
    needing one and dy random, equal bit for bit to a second, direct call;
    its time beside the plain version's.  The bound: the
    essential work, 6 K V multiply-adds per (b, t, h) (the state
    recomputed, dr, the dS update, dk, dv, dw) in float32 on the tensor
    cores (3xTF32: three TF32 products each, as the WKV6 forward and the
    float32 flash backward are bounded), against r, k, v, w and dy read, dr,
    dk, dv and dw written and the float32 states once; the same work at the
    float32 rate of the CUDA cores gives ``fma_bound_ms``.  No PyTorch call
    computes this gradient: library none."""
    from repro_torch.kernels import wkv6, wkv6_backward
    from repro_torch.kernels.rwkv6_wkv import wkv6_bwd_ref

    gen = torch.Generator(device=dev).manual_seed(27)
    rows = []
    for name, b, t, h, kk, dt, nonzero, model, reps in WKV_BWD_CASES:
        xs = wkv6_bwd_inputs(torch, dev, gen, b, t, h, kk, dt, nonzero, model)
        r, k, v, w, u, s0, dy, ds = xs
        # the gradient as training takes it: autograd through wkv6, every
        # input needing one (a None final-state gradient where ds is None)
        leaves = [x.detach().requires_grad_() for x in xs[:6]]
        launches = (wkv6.launches, wkv6_backward.launches)
        y, s = wkv6(*leaves)
        ours = torch.autograd.grad((y, s) if nonzero else (y,), leaves,
                                   (dy, ds) if nonzero else (dy,))
        again = wkv6_backward(*xs)
        torch.cuda.synchronize()
        check((wkv6.launches, wkv6_backward.launches) == (launches[0] + 1, launches[1] + 2),
              f"wkv6 bwd {name}: launches")
        equal = all(torch.equal(a, c) for a, c in zip(ours, again))
        del again, y, s, leaves
        ref = wkv6_bwd_ref(*xs)
        errs, uses = {}, {}
        for gname, a, e in zip(("dr", "dk", "dv", "dw", "du", "dstate"), ours, ref):
            rtol, atol, share = WKV_BWD_TOL["float32" if gname == "dstate" else dt]
            a, e = a.float(), e.float()
            d = (a - e).abs()
            errs[gname] = float(d.max())
            uses[gname] = float((d / (rtol * e.abs() + atol + share * e.abs().max())
                                 .clamp_min(1e-30)).max())
            check(bool(torch.isfinite(a).all()), f"wkv6 bwd {name}: {gname} not finite")
        zeros, ones = int((w == 0).sum()), int((w == 1).sum())
        del ours, ref
        sets = rotation(xs[:7]) if ds is None else rotation(xs)
        ms, plain_ms, call_ms, plain_call_ms = kernel_and_plain_ms(
            torch, [lambda c=c: wkv6_backward(*c) for c in sets],
            [lambda c=c: wkv6_bwd_ref(*c) for c in sets], reps)
        elem = r.element_size()
        nbytes = 9 * b * t * h * kk * elem + 2 * u.numel() * elem + \
            (3 if nonzero else 2) * b * h * kk * kk * 4
        flops = 12.0 * b * t * h * kk * kk
        bound_ms, bound_by = bound(nbytes, 3 * flops, TF32_FLOPS_PER_S)
        fma_bound_ms = bound(nbytes, flops)[0]
        worst = max(uses, key=uses.get)
        row = dict(shape=name, b=b, t=t, h=h, k=kk, dtype=dt, nonzero_state=nonzero,
                   model_decays=model, w_zeros=zeros, w_ones=ones,
                   max_abs_err=max(errs.values()), max_abs_errs=errs, limit_use=uses,
                   equal_bits=equal, ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                   plain_call_ms=plain_call_ms, bound_ms=bound_ms, bound_by=bound_by,
                   bound_share=bound_ms / ms, fma_bound_ms=fma_bound_ms, library_ms=None)
        rows.append(row)
        print(f"wkv6 bwd {name:17s} B={b} T={t} H={h} K={kk} {dt}"
              f"{' nonzero state and dstate_out' if nonzero else ''}"
              f"{f' model decays ({zeros} zeros, {ones} ones)' if model else ''}: "
              + ", ".join(f"{g} {uses[g]:.3f}" for g in uses)
              + f" of the limit (worst {worst}, max_err {errs[worst]:.3g}); two runs equal "
              f"bit for bit: {equal}; ms={ms:.4f} call_ms={call_ms:.4f} plain_ms={plain_ms:.1f}"
              f" library: none bound_ms={bound_ms:.4f} ({bound_by}; {bound_ms / ms:.1%} of "
              f"it) fma_bound_ms={fma_bound_ms:.4f}")
        check(uses[worst] <= 1.0, f"wkv6 bwd {name}: {worst} {uses[worst]:.3g} of its limit")
        check(equal, f"wkv6 bwd {name}: two runs differ")
        del r, k, v, w, u, s0, dy, ds, xs, sets
    return rows


def plain_attention(torch, reorder: float = 0.0):
    """Context: the flash wrapper's forward and backward on the card run
    their plain versions (``ops._forward`` and ``ops._backward`` patched
    here; the package has no switch for it), for the gradient check.  With
    ``reorder`` the plain forward's float32 output is multiplied by (1 +
    reorder N(0, 1)) before its cast to the input type, as another order of
    its float32 sums moves it (`plain_wkv6`'s yardstick: the noise from a
    generator seeded `YARDSTICK_SEED` at each call, so a layer's
    checkpointed recompute draws what its forward drew)."""
    import contextlib

    from repro_torch.kernels.flash_attention import attention_bwd_ref, attention_ref, ops

    def forward(q, k, v, c, s, lse=None):
        if not reorder:
            return attention_ref(q, k, v, causal=c, sm_scale=s)
        o = attention_ref(q.float(), k.float(), v.float(), causal=c, sm_scale=s)
        gen = torch.Generator(device=o.device).manual_seed(YARDSTICK_SEED)
        noise = torch.randn(o.shape, generator=gen, device=o.device)
        return (o * (1 + reorder * noise)).to(q.dtype)

    @contextlib.contextmanager
    def patched():   # the plain backward recomputes the softmax, as before
        real = ops._forward, ops._backward
        ops._forward = forward
        ops._backward = lambda q, k, v, o, do, c, s, lse=None: attention_bwd_ref(
            q, k, v, o, do, causal=c, sm_scale=s)
        try:
            yield
        finally:
            ops._forward, ops._backward = real
    return patched()


def plain_wkv6(torch, forward: bool = True, backward: bool = True, reorder: float = 0.0):
    """Context: rwkv6's recurrence on the card runs its plain versions, both
    (``models.rwkv6.wkv6`` patched to ``wkv6_ref``, the plain loop, which
    autograd differentiates) or one of them inside the wrapper (its
    ``ops._forward`` patched to ``wkv6_ref`` or its ``ops._backward`` to
    ``wkv6_bwd_ref``, the other staying the kernel); the package has no
    switch for any.  For the gradient check.  With ``reorder`` (both plain)
    the plain loop's float32 y is multiplied by (1 + reorder N(0, 1)) before
    its cast to the input type, as another order of the float32 sums moves
    it: the noise comes from a generator seeded `YARDSTICK_SEED` at each
    call, so a layer's checkpointed recompute draws what its forward drew."""
    import contextlib

    from repro_torch.kernels.rwkv6_wkv import ops, wkv6_bwd_ref, wkv6_ref
    from repro_torch.models import rwkv6

    def reordered(r, k, v, w, u, state):
        y, s = wkv6_ref(*(x.float() for x in (r, k, v, w, u)), state)
        gen = torch.Generator(device=y.device).manual_seed(YARDSTICK_SEED)
        noise = torch.randn(y.shape, generator=gen, device=y.device)
        return (y * (1 + reorder * noise)).to(r.dtype), s

    @contextlib.contextmanager
    def patched():
        real = rwkv6.wkv6, ops._forward, ops._backward
        if forward and backward:
            rwkv6.wkv6 = reordered if reorder else wkv6_ref
        elif forward:
            ops._forward = lambda *a: wkv6_ref(*a)
        elif backward:
            ops._backward = lambda *a: wkv6_bwd_ref(*a)
        try:
            yield
        finally:
            rwkv6.wkv6, ops._forward, ops._backward = real
    return patched()


#: rwkv6's gradient check: (name, forward, backward), each side the kernel
#: or its plain version (`plain_wkv6`; forward "reordered": the plain loop
#: with its float32 y moved by `YARDSTICK_EPS` before the cast, bfloat16
#: only); the launches each run makes per layer; and the pairs compared,
#: (run, against, held in bfloat16, held in float32), a hold None (printed),
#: "share" (each leaf within `GRAD_CHECK_SHARE` of its largest element and
#: the loss within `GRAD_CHECK_LOSS_RTOL`) or "yardstick" (the worst leaf
#: and the median leaf each at most `YARDSTICK_FACTOR` times the yardstick's,
#: and the loss as for "share"):
#: - the backward kernel under the plain forward against the plain loop,
#:   nothing of the program on the reference side (share);
#: - both kernels against the forward kernel with the plain reverse
#:   recurrence, the backward kernel alone on the same forward (share);
#: - the yardstick: the plain loop with y reordered against the plain loop,
#:   what any other float32 summation order of y does to the bfloat16
#:   model's gradients at random initialisation (printed);
#: - both kernels, and the forward kernel with the plain backward, against
#:   the plain loop (yardstick in bfloat16; both kernels share in float32).
RWKV_GRAD_RUNS = (("kernels", "kernel", "kernel", (2, 1)),
                  ("plain_fwd_kernel_bwd", "plain", "kernel", (0, 1)),
                  ("kernel_fwd_plain_bwd", "kernel", "plain", (2, 0)),
                  ("plain_loop", "plain", "plain", (0, 0)),
                  ("plain_loop_reordered", "reordered", "plain", (0, 0)))
RWKV_GRAD_PAIRS = (("plain_fwd_kernel_bwd", "plain_loop", "share", None),
                   ("kernels", "kernel_fwd_plain_bwd", "share", None),
                   ("plain_loop_reordered", "plain_loop", None, None),
                   ("kernels", "plain_loop", "yardstick", "share"),
                   ("kernel_fwd_plain_bwd", "plain_loop", "yardstick", None))
YARDSTICK = ("plain_loop_reordered", "plain_loop")
YARDSTICK_EPS = 1e-6
YARDSTICK_SEED = 1
YARDSTICK_FACTOR = 2.0


def rwkv6_grad_check(torch, dev, seed: int = 0) -> dict:
    """rwkv6-7b at full width and `GRAD_CHECK_LAYERS` layers: one loss and
    gradient of ``registry.loss_fn`` for each of `RWKV_GRAD_RUNS` (in
    float32 only both kernels and the plain loop), on the same weights and
    batch (generator ``seed``, the data's seed ``seed``), each run's WKV6
    launches checked, and the pairs of `RWKV_GRAD_PAIRS` compared leaf by
    leaf."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.convert import to_port_layout
    from repro_torch.device import generator
    from repro_torch.kernels import wkv6, wkv6_backward
    from repro_torch.models import registry
    from repro_torch.models.param import spec_leaves, tree_leaves
    from repro_torch.training.data import data_iterator
    from repro_torch.training.train_step import init_params

    out = {}
    for dt in ("bfloat16", "float32"):
        cfg = dataclasses.replace(get_config("rwkv6-7b"), num_layers=GRAD_CHECK_LAYERS,
                                  dtype=dt)
        params = init_params(cfg, generator(seed, dev), dev)
        names = ["/".join(p) for p, _ in spec_leaves(registry.abstract_params(cfg))]
        batch = next(data_iterator(cfg.vocab_size, 4, 256, seed=seed))
        batch = {k: torch.as_tensor(v, dtype=torch.long, device=dev) for k, v in batch.items()}
        runs = {}
        for label, fwd, bwd, per_layer in RWKV_GRAD_RUNS:
            if dt == "float32" and label not in ("kernels", "plain_loop"):
                continue
            counts = (wkv6.launches, wkv6_backward.launches)
            with plain_wkv6(torch, forward=fwd != "kernel", backward=bwd == "plain",
                            reorder=YARDSTICK_EPS if fwd == "reordered" else 0.0):
                loss, _ = registry.loss_fn(to_port_layout(params), batch, cfg)
                grads = torch.autograd.grad(loss, tree_leaves(params))
                torch.cuda.synchronize()
            launched = (wkv6.launches - counts[0], wkv6_backward.launches - counts[1])
            want = tuple(n * GRAD_CHECK_LAYERS for n in per_layer)
            check(launched == want, f"rwkv6 grad check {dt}: {label} launched {launched}")
            for name, g in zip(names, grads):
                check(bool(torch.isfinite(g).all()),
                      f"rwkv6 grad check {dt}: {label} {name} not finite")
            runs[label] = (float(loss.detach()), grads, launched)
            del loss
        row = {}
        for label, against, hold_bf16, hold_f32 in RWKV_GRAD_PAIRS:
            if label not in runs or against not in runs:
                continue
            held = hold_bf16 if dt == "bfloat16" else hold_f32
            (loss_k, grads_k, launched), (loss_p, grads_p, _) = runs[label], runs[against]
            sh = {n: float((a.float() - b.float()).abs().max())
                  / max(float(b.float().abs().max()), 1e-30)
                  for n, a, b in zip(names, grads_k, grads_p)}
            worst = max(sh, key=sh.get)
            median = statistics.median(sh.values())
            loss_rel = abs(loss_k - loss_p) / abs(loss_p)
            if held == "yardstick":
                yard = row["_vs_".join(YARDSTICK)]
                tol = (YARDSTICK_FACTOR * yard["worst_share"],
                       YARDSTICK_FACTOR * yard["median_share"])
            else:
                tol = (GRAD_CHECK_SHARE, None)
            row[f"{label}_vs_{against}"] = dict(
                loss=loss_k, loss_against=loss_p, loss_rel=loss_rel, worst_leaf=worst,
                worst_share=sh[worst], median_share=median, launches=launched, held=held,
                **({"tol_worst": tol[0], "tol_median": tol[1]} if held else {}))
            limits = ("" if not held else f" (tol {tol[0]:.4g}" + (
                f", median tol {tol[1]:.4g})" if tol[1] is not None else ")"))
            print(f"rwkv6 grad check: rwkv6-7b full width, {GRAD_CHECK_LAYERS} layers, B 4 S "
                  f"256 {dt}, {label} against {against}"
                  f"{f' (held: {held})' if held else ' (not held)'}: loss "
                  f"{loss_k:.6f} / {loss_p:.6f} (rel {loss_rel:.3g}, tol "
                  f"{GRAD_CHECK_LOSS_RTOL}); {len(sh)} gradient leaves, largest max|a-b|/max|b| "
                  f"{sh[worst]:.4g} at {worst}{limits}, median {median:.4g}; launches "
                  f"forward {launched[0]} backward {launched[1]}")
            if held:
                for name in sorted(sh):
                    print(f"  rwkv6 grad check {dt} {label} {name}: {sh[name]:.4g}")
                check(loss_rel <= GRAD_CHECK_LOSS_RTOL,
                      f"rwkv6 grad check {dt}: {label} and {against}: losses differ")
                check(sh[worst] <= tol[0],
                      f"rwkv6 grad check {dt}: {label} and {against}: {worst} differs")
                check(tol[1] is None or median <= tol[1],
                      f"rwkv6 grad check {dt}: {label} and {against}: median leaf "
                      f"{median:.4g} over {tol[1]}")
        out[dt] = row
        del params, runs
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_attention_calls(cfg) -> tuple:
    """(flash forward, flash backward) launches of one loss and gradient of
    the training objective of ``cfg``: ``registry.loss_fn`` for a model
    config, ``dit.diffusion_loss`` for a Wan pipeline config.  Every family's
    layers run under ``torch.utils.checkpoint``, so a flash attention there
    launches its forward twice (the forward and the recompute) and its
    backward once: a transformer's full-attention layers (a windowed layer
    is plain PyTorch), whisper's encoder self-attention and its decoder's
    self- and cross-attention, zamba2's shared block at each place, none in
    rwkv6.  The DiT is not checkpointed: a self- and a cross-attention a
    layer, each once forward and once backward."""
    from repro_torch.configs.wan_i2v import WanPipelineConfig
    from repro_torch.models import mamba2, transformer

    if isinstance(cfg, WanPipelineConfig):
        return 2 * cfg.dit_layers, 2 * cfg.dit_layers
    if cfg.family == "ssm":
        n = 0
    elif cfg.family == "hybrid":
        n = mamba2._periods(cfg)[0] if cfg.hybrid_attn_every else 0
    elif cfg.family == "audio":
        n = cfg.encoder_layers + 2 * cfg.num_layers
    else:
        n = sum(1 for *_, w in transformer.layer_slots(cfg) if not w)
    return 2 * n, n


def fan_in_weights(torch, params, spec_tree) -> None:
    """In place: each stacked matrix leaf of ``params`` (the JAX layout,
    [L, ...], drawn by the init rule, whose fan_in = shape[0] is the layer
    count) and each HWIO convolution (whose shape[0] is its height)
    rescaled to std 1 / sqrt(its contracted fan-in), as the CPU parity
    tests draw it: the product of the axes but the last for a convolution
    and of the per-layer axes but the last for an output projection
    (``*wo``), else the first per-layer axis.  A depthwise convolution's
    taps (``conv_w``) keep the rule's draw."""
    from repro_torch.models.param import spec_leaves

    with torch.no_grad():
        for path, s in spec_leaves(spec_tree):
            if s.init != "normal" or path[-1] == "conv_w":
                continue
            if s.logical[0] == "layers":
                per = s.shape[1:]
                fan = math.prod(per[:-1]) if path[-1].endswith("wo") else per[0]
            elif len(s.shape) == 4:
                fan = math.prod(s.shape[:-1])
            else:
                continue
            leaf = params
            for k in path:
                leaf = leaf[k]
            leaf.mul_(math.sqrt(s.shape[0] / fan))


def leaf_shares(torch, label: str, names, grads, refs) -> dict:
    """name -> max|a - b| / max|b| of each gradient leaf against its
    reference; fails at a leaf that is not finite."""
    out = {}
    for name, a, b in zip(names, grads, refs):
        check(bool(torch.isfinite(a).all()), f"{label}: {name} not finite")
        a, b = a.float(), b.float()
        out[name] = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
    return out


def grad_check(torch, label: str, loss_of, leaves, names, want,
               loss_rtol: float = GRAD_CHECK_LOSS_RTOL,
               share: float = GRAD_CHECK_SHARE, yardstick: bool = False) -> dict:
    """One loss (``loss_of()``) and its gradient with respect to ``leaves``
    through the flash kernels, then the same with the attention's forward
    and backward patched to their plain versions (`plain_attention`): the
    kernel run's (forward, backward) launches equal to ``want``, none in the
    plain run, every leaf finite; the loss within ``loss_rtol`` relative and
    every leaf (``names``) within ``share`` as max|a - b| / max|b|, printed
    leaf by leaf, with each run's wall ms and peak memory.  With
    ``yardstick`` (a model whose top-k routing turns a rounding of the
    attention's output into another expert for a token) a third run, the
    plain attention with its float32 output moved by `YARDSTICK_EPS`
    before the cast, against the plain run gives the yardstick: the worst
    and the median leaf are then held within the larger of ``share`` and
    `YARDSTICK_FACTOR` times the yardstick's, as rwkv6's check holds its
    pairs."""
    from repro_torch.kernels import flash_attention, flash_attention_backward

    def run():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts = (flash_attention.launches, flash_attention_backward.launches)
        t0 = time.perf_counter()
        loss = loss_of()
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        return (float(loss.detach()), grads, wall_ms, torch.cuda.max_memory_allocated() / 2 ** 30,
                (flash_attention.launches - counts[0],
                 flash_attention_backward.launches - counts[1]))

    kernels = run()
    with plain_attention(torch):
        plain = run()
    check(kernels[4] == tuple(want),
          f"{label}: the kernel run launched {kernels[4]} (forward, backward), not {want}")
    check(plain[4] == (0, 0), f"{label}: the plain run launched {plain[4]}")
    shares = leaf_shares(torch, label, names, kernels[1], plain[1])
    worst = max(shares, key=shares.get)
    loss_rel = abs(kernels[0] - plain[0]) / abs(plain[0])
    out = dict(loss_kernels=kernels[0], loss_plain=plain[0], loss_rel=loss_rel,
               worst_leaf=worst, worst_share=shares[worst],
               median_share=statistics.median(shares.values()), launches=kernels[4],
               wall_ms=kernels[2], peak_gib=kernels[3], plain_wall_ms=plain[2],
               plain_peak_gib=plain[3])
    limits = (share, share)
    if yardstick:
        with plain_attention(torch, YARDSTICK_EPS):
            moved = run()
        yard = leaf_shares(torch, label, names, moved[1], plain[1])
        out.update(yardstick_worst=max(yard.values()),
                   yardstick_median=statistics.median(yard.values()))
        limits = (max(share, YARDSTICK_FACTOR * out["yardstick_worst"]),
                  max(share, YARDSTICK_FACTOR * out["yardstick_median"]))
        print(f"{label}: yardstick (the plain attention's output moved by {YARDSTICK_EPS:g} "
              f"before its cast, against the plain run): loss rel "
              f"{abs(moved[0] - plain[0]) / abs(plain[0]):.3g}, worst leaf "
              f"{out['yardstick_worst']:.4g}, median {out['yardstick_median']:.4g}; held: "
              f"worst <= {limits[0]:.4g}, median <= {limits[1]:.4g}")
        del moved
    out.update(limits=limits)
    del kernels, plain
    print(f"{label}: loss kernels {out['loss_kernels']:.6f} plain {out['loss_plain']:.6f} "
          f"(rel {loss_rel:.3g}, tol {loss_rtol}); {len(shares)} gradient leaves, largest "
          f"max|a-b|/max|b| {shares[worst]:.4g} at {worst} (tol {limits[0]:.4g}), median "
          f"{out['median_share']:.4g}; launches forward {out['launches'][0]} backward "
          f"{out['launches'][1]}; wall {out['wall_ms']:.1f} ms, peak {out['peak_gib']:.2f} GiB "
          f"(plain {out['plain_wall_ms']:.1f} ms, {out['plain_peak_gib']:.2f} GiB)")
    for name in sorted(shares):
        print(f"  {label} {name}: {shares[name]:.4g}")
    check(loss_rel <= loss_rtol, f"{label}: the losses differ")
    check(shares[worst] <= limits[0], f"{label}: {worst} differs")
    check(out["median_share"] <= limits[1], f"{label}: the median leaf differs")
    return out


def softmax_peak(torch, q, k, causal: bool, scale: float, rows: int = 1024) -> tuple:
    """(largest |score|, a row's largest softmax weight on average) over the
    first ``rows`` query rows of every (batch, head) of an attention call."""
    group = q.shape[2] // k.shape[2]
    kpos = torch.arange(k.shape[1], device=q.device)
    top, peak, n = 0.0, 0.0, 0
    for bi in range(q.shape[0]):
        for hi in range(q.shape[2]):
            s = (q[bi, :rows, hi].float() * scale) @ k[bi, :, hi // group].float().T
            if causal:
                s = s.masked_fill(kpos[None, :] > kpos[:s.shape[0], None], -math.inf)
            top = max(top, float(s[s.isfinite()].abs().max()))
            peak += float(torch.softmax(s, dim=-1).amax(-1).sum())
            n += s.shape[0]
    return top, peak / n


def attention_f64(torch, q, k, v, o, do, causal: bool, scale: float, q_chunk: int = 2048,
                  magnitudes: bool = False):
    """[o, dq, dk, dv] in float64 (``attention_ref`` and ``attention_bwd_ref``
    compute in float32 whatever their inputs): softmax(q k^T scale) v, and
    the gradient for the output gradient ``do`` given the forward's output
    ``o`` (in delta = rowsum(dO o), as the backward kernels and
    ``attention_bwd_ref`` take it); one (batch, head) pair and one chunk of
    query rows at a time.  With ``magnitudes`` also, per element, the sum
    of the magnitudes of the terms it sums (`F32_TERM_STEPS`): for o, P |v|;
    for dq and dk, those of dS = P (dP - delta) with dP's own terms, P (|dO|
    |V|^T + |delta|), times |k| or |q| and the scale; for dv, P^T |dO|."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    group = h // kv
    f64 = dict(dtype=torch.float64, device=q.device)
    out, dq = torch.empty(q.shape, **f64), torch.empty(q.shape, **f64)
    dk, dv = torch.zeros(k.shape, **f64), torch.zeros(v.shape, **f64)
    mags = ([torch.empty(q.shape, **f64), torch.empty(q.shape, **f64),
             torch.zeros(k.shape, **f64), torch.zeros(v.shape, **f64)] if magnitudes else None)
    kpos = torch.arange(sk, device=q.device)
    for bi in range(b):
        for hi in range(h):
            kh, vh = k[bi, :, hi // group].double(), v[bi, :, hi // group].double()
            for r0 in range(0, sq, q_chunk):
                rows = slice(r0, r0 + q_chunk)
                qh = q[bi, rows, hi].double() * scale
                s = qh @ kh.T
                if causal:
                    qpos = torch.arange(r0, r0 + qh.shape[0], device=q.device)
                    s = s.masked_fill(kpos[None, :] > qpos[:, None], -math.inf)
                p = torch.softmax(s, dim=-1)
                oh = p @ vh
                doh = do[bi, rows, hi].double()
                delta = (doh * o[bi, rows, hi].double()).sum(-1, keepdim=True)
                ds = p * (doh @ vh.T - delta)
                out[bi, rows, hi] = oh
                dq[bi, rows, hi] = ds @ kh * scale
                dk[bi, :, hi // group] += ds.T @ qh
                dv[bi, :, hi // group] += p.T @ doh
                if magnitudes:
                    w = p * (doh.abs() @ vh.abs().T + delta.abs())
                    mags[0][bi, rows, hi] = p @ vh.abs()
                    mags[1][bi, rows, hi] = w @ kh.abs() * scale
                    mags[2][bi, :, hi // group] += w.T @ qh.abs()
                    mags[3][bi, :, hi // group] += p.T @ doh.abs()
    return ([out, dq, dk, dv], mags) if magnitudes else [out, dq, dk, dv]


#: keys (forward) and rows (backward) of a tile of the bfloat16 flash kernels
FLASH_TILE = 64


def split_bf16(x, terms: int) -> list:
    """float32 ``x`` as ``terms`` bfloat16 terms, each the rounding of what
    the ones before it leave (hi, mid, lo), as float64 tensors."""
    out, rest = [], x.float()
    for _ in range(terms):
        t = rest.bfloat16().float()
        out.append(t.double())
        rest = rest - t
    return out


def _trunc32(torch, x):
    """float64 ``x`` rounded to float32 toward zero, as float64."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y).double()


def tc_sum(torch, a_terms, b, tc: bool, acc=None, per_step: bool = False):
    """acc + sum of a @ b over ``a_terms`` (float64), contracting a's last
    axis with b's second to last.  ``tc``: as `wgmma` adds, each k-step of
    16 summed exactly and added into the float32 accumulator truncated
    toward zero, term after term (acc None: a zeroed fragment); with
    ``per_step`` each k-step into a zeroed fragment instead, added in
    float32 (round to nearest); else in float64."""
    if not tc:
        r = sum(a @ b for a in a_terms)
        return r if acc is None else acc + r
    out = acc if acc is not None else torch.zeros(
        a_terms[0].shape[:-1] + b.shape[-1:], dtype=torch.float64, device=b.device)
    for k0 in range(0, b.shape[-2], 16):
        for a in a_terms:
            step = a[..., k0:k0 + 16] @ b[..., k0:k0 + 16, :]
            out = (out.float() + _trunc32(torch, step).float()).double() if per_step else (
                _trunc32(torch, out + step))
    return out


def _heads(x, group: int):
    """[B, S, KV, D] -> [B, KV group, S, D] float64 (GQA's repeat)."""
    return x.double().transpose(1, 2).repeat_interleave(group, dim=1)


def emulate_bf16_forward(torch, q, k, v, causal: bool, scale: float, terms: int,
                         tc: bool = False):
    """``flash_attention_bf16.cu``'s arithmetic in float64 on q [B, Sq, H, D],
    k, v [B, Sk, KV, D] (bfloat16): float32 scores in log2 units, the online
    softmax over tiles of FLASH_TILE keys with m, l and p in float32, P V
    with p as ``terms`` bfloat16 terms (`split_bf16`), the output rounded
    once to bfloat16.  ``tc`` False: P V summed in float64 (only the split
    is the kernel's).  ``tc`` True: every product as the tensor core adds
    (`tc_sum`); S = Q K^T in one accumulator; each tile's P V in a zeroed
    fragment added to O in float32 where ``terms`` is 3 (the kernel now),
    into O itself where 2 (the kernel before)."""
    b, sq, h, d = q.shape
    sk, g = k.shape[1], q.shape[2] // k.shape[2]
    qh, kh, vh = q.double().transpose(1, 2), _heads(k, g), _heads(v, g)
    s_all = (tc_sum(torch, [qh], kh.transpose(-1, -2), tc).float()
             * torch.tensor(scale * math.log2(math.e), dtype=torch.float32))
    if causal:
        kpos = torch.arange(sk, device=q.device)
        s_all = s_all.masked_fill(kpos[None, :] > kpos[:sq, None], -math.inf)
    m = torch.full((b, h, sq, 1), -math.inf, device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    acc = torch.zeros((b, h, sq, d), dtype=torch.float64, device=q.device)
    for k0 in range(0, sk, FLASH_TILE):
        s = s_all[..., k0:k0 + FLASH_TILE]
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        base = torch.where(mn == -math.inf, torch.zeros_like(mn), mn)
        corr = torch.exp2(m - base)
        p = torch.exp2(s - base)
        l = l * corr + p.sum(-1, keepdim=True)
        m = mn
        parts, vt = split_bf16(p, terms), vh[..., k0:k0 + FLASH_TILE, :]
        if not tc:
            acc = acc * corr.double() + tc_sum(torch, parts, vt, False)
        elif terms == 3:
            acc = (acc.float() * corr).double() + tc_sum(torch, parts, vt, True)
            acc = acc.float().double()
        else:
            acc = tc_sum(torch, parts, vt, True, (acc.float() * corr).double())
    return (acc.float() * (1.0 / l.clamp_min(1e-30))).bfloat16().transpose(1, 2)


def emulate_bf16_backward(torch, q, k, v, o, do, lse, causal: bool, scale: float,
                          terms: int, tc: bool = False):
    """``flash_attention_bwd_bf16.cu``'s arithmetic in float64 on q, o, do
    [B, Sq, H, D], k, v [B, Sk, KV, D] (bfloat16) and the forward's
    log-sum-exp ``lse`` [B, H, Sq]: float32 S and dP, P = exp2(S scale log2 e
    - lse log2 e), delta = rowsum(dO o) and dS = P (dP - delta) in float32;
    dq += dS K and dk += dS^T Q with dS as ``terms`` bfloat16 terms, dv +=
    P^T dO with P in two; each tile of FLASH_TILE keys (dq) or query rows
    (dk, dv) summed apart and added in float32, dk and dv over the group's
    heads in order; each result rounded once to bfloat16.  delta is summed
    in float64 and rounded to float32, as the kernel's pre-pass does.
    ``tc`` False: every product in float64 (only the splits are the
    kernel's); True: every product as the tensor core adds (`tc_sum`), dP
    in one accumulator where ``terms`` is 2 (the kernel before), one k-step
    at a time where 3 (now)."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    qh, doh, oh = (x.double().transpose(1, 2) for x in (q, do, o))
    kh, vh = _heads(k, g), _heads(v, g)
    s = tc_sum(torch, [qh], kh.transpose(-1, -2), tc).float()
    dp = tc_sum(torch, [doh], vh.transpose(-1, -2), tc, per_step=terms == 3).float()
    p = torch.exp2(s * torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
                   - (lse.float() * torch.tensor(math.log2(math.e), dtype=torch.float32))[..., None])
    if causal:
        kpos = torch.arange(sk, device=q.device)
        p = p.masked_fill(kpos[None, :] > kpos[:sq, None], 0.0)
    delta = (doh * oh).sum(-1).float()
    ds = p * (dp - delta[..., None])

    def tiled(x, y, n):
        """sum over tiles of FLASH_TILE along x's last axis of x @ y, x as n terms;
        -> [..., tiles, rows, D] of each tile's fragment."""
        frags = [tc_sum(torch, split_bf16(x[..., t0:t0 + FLASH_TILE], n),
                        y[..., t0:t0 + FLASH_TILE, :], tc)
                 for t0 in range(0, x.shape[-1], FLASH_TILE)]
        return torch.stack(frags, dim=-3)

    def in_order(frags):     # [B, heads, tiles, rows, D] -> float32 sums, heads then tiles
        acc = torch.zeros(frags.shape[:1] + frags.shape[3:], dtype=torch.float32,
                          device=q.device)
        for hh in range(frags.shape[1]):
            for t in range(frags.shape[2]):
                acc = acc + frags[:, hh, t].float()
        return acc

    dq = torch.stack([in_order(f[:, None]) for f in tiled(ds, kh, terms).unbind(1)], dim=2)
    dk_f = tiled(ds.transpose(-1, -2), qh, terms)
    dv_f = tiled(p.transpose(-1, -2), doh, 2)
    dk = torch.stack([in_order(dk_f[:, j * g:(j + 1) * g]) for j in range(kv)], dim=2)
    dv = torch.stack([in_order(dv_f[:, j * g:(j + 1) * g]) for j in range(kv)], dim=2)
    return [(dq * scale).bfloat16(), (dk * scale).bfloat16(), dv.bfloat16()]


def split_readings(torch, q, k, v, o, do, lse, causal: bool, scale: float, exact,
                   floors=(None,) * 4) -> dict:
    """The bfloat16 kernels' arithmetic emulated on these inputs
    (`emulate_bf16_forward`, `emulate_bf16_backward`; dO already scaled, o
    and lse the forward kernel's): for P and dS in 2 and in 3 bfloat16
    terms, with every product in float64 (``f64_2``, ``f64_3``) and as the
    tensor core adds (``tc_2``: the kernels before, ``tc_3``: now), each of
    o, dq, dk, dv as its largest share of the bfloat16 elementwise limit
    (plus ``floors``, `limit_errs`) from ``exact`` (`attention_f64`'s [o,
    dq, dk, dv])."""
    names = ("o", "dq", "dk", "dv")
    out = {}
    for tc in (False, True):
        for terms in (2, 3):
            emu = [emulate_bf16_forward(torch, q, k, v, causal, scale, terms, tc),
                   *emulate_bf16_backward(torch, q, k, v, o, do, lse, causal, scale, terms, tc)]
            out[f"{'tc' if tc else 'f64'}_{terms}"] = {
                n: limit_errs(a, e, floor=f)[1] for n, a, e, f in zip(names, emu, exact, floors)}
            del emu
    return out


def print_split_readings(label: str, kernel: dict, emu: dict) -> None:
    print(f"{label}: of the bf16 elementwise limit from float64, o / dq / dk / dv: kernels "
          + " / ".join(f"{kernel[n]:.4g}" for n in ("o", "dq", "dk", "dv")) + "; emulated "
          + "; ".join(f"{key.replace('_', ' products, ')} terms "
                      + " / ".join(f"{r[n]:.4g}" for n in ("o", "dq", "dk", "dv"))
                      for key, r in emu.items()))


def init_attention_check(torch, label: str, loss_of, leaves, want,
                         elementwise: bool = False) -> list:
    """One loss and gradient through the flash kernels on the init rule's
    weights, its launches equal to ``want``, every backward call's inputs
    (q, k, v, the forward kernel's o and log-sum-exp, dO) and results
    recorded (``ops._backward`` wrapped here; the package has no switch for
    it).  dO and the kernel's results are multiplied by the power of two
    that brings dO's largest element into [1, 2), as the kernel phase's
    N(0, 1) dO are (exact: the backward is linear in dO).  Each of the
    kernels' o, dq, dk and dv is held within ONE_HOT_SHARE of its largest
    element from the float64 result (`attention_f64`; the gradient given
    the kernel's o); with ``elementwise`` (`ELEMENTWISE_INIT_FAMILIES`, whose
    scores stay small) also within the dtype's elementwise limit of it,
    with the kernels' bfloat16 arithmetic emulated beside
    (`split_readings`).  Where a score reaches thousands the softmax is
    one-hot (`FAMILY_GRAD_CHECKS`) and no float32 computation meets the
    elementwise limit.  Printed beside: the kernel phase's measure, the
    largest share of the dtype's elementwise limit against the plain
    versions (``attention_ref``, ``attention_bwd_ref`` on the kernel's o);
    the plain path's (its own forward, then its backward) share and
    elementwise measure from float64, the same; and how far the forward
    moves o from the plain float32 output rounded to the dtype, summed over
    o, against what moving that output one float32 step does (each
    direction drawn as `plain_wkv6`'s yardstick draws it)."""
    import contextlib

    from repro_torch.kernels import flash_attention, flash_attention_backward
    from repro_torch.kernels.flash_attention import attention_bwd_ref, attention_ref, ops

    calls = []

    @contextlib.contextmanager
    def recording():
        real = ops._backward

        def backward(q, k, v, o, do, c, s, lse=None):
            grads = real(q, k, v, o, do, c, s, lse)
            calls.append(([x.detach().clone() for x in (q, k, v, o, do)],
                          None if lse is None else lse.clone(), c, s,
                          [g.clone() for g in grads]))
            return grads
        ops._backward = backward
        try:
            yield
        finally:
            ops._backward = real

    counts = (flash_attention.launches, flash_attention_backward.launches)
    with recording():
        torch.autograd.grad(loss_of(), leaves)
        torch.cuda.synchronize()
    launched = (flash_attention.launches - counts[0],
                flash_attention_backward.launches - counts[1])
    check(launched == tuple(want),
          f"{label}: the init weights' run launched {launched} (forward, backward), not {want}")
    names = ("o", "dq", "dk", "dv")
    rows, missed = [], []
    for i, ((q, k, v, o, do), lse, causal, scale, ours) in enumerate(calls):
        dt = str(q.dtype).removeprefix("torch.")
        tol = (BF16_ATOL, BF16_RTOL) if dt == "bfloat16" else (F32_ATOL, F32_RTOL)
        o32 = attention_ref(*(x.float() for x in (q, k, v)), causal=causal, sm_scale=scale)
        plain_o = o32.to(q.dtype)
        gen = torch.Generator(device=o.device).manual_seed(YARDSTICK_SEED)
        up = torch.rand(o.shape, generator=gen, device=o.device) < 0.5
        step = torch.nextafter(o32, torch.where(up, math.inf, -math.inf)).to(q.dtype)
        moved = float((o.float() - plain_o.float()).abs().sum())
        one_step = float((step.float() - plain_o.float()).abs().sum())
        del o32, step, up
        do_max = float(do.float().abs().max())
        gain = 2.0 ** -math.floor(math.log2(do_max)) if do_max > 0 else 1.0
        do = do * gain
        kernels = [o, *(g * gain for g in ours)]
        plain = [plain_o, *attention_bwd_ref(q, k, v, plain_o, do, causal=causal,
                                             sm_scale=scale)]
        vs_plain = max(limit_errs(a, r, *tol)[1] for a, r in zip(kernels, [plain_o, *(
            attention_bwd_ref(q, k, v, o, do, causal=causal, sm_scale=scale))]))
        largest, exact_kernels = {}, []

        def from_exact(outs):
            exact = attention_f64(torch, q, k, v, outs[0], do, causal, scale)
            largest.update({n: float(e.abs().max()) for n, e in zip(names, exact)})
            if outs is kernels:
                exact_kernels.extend(exact)
            return {n: (float((a.double() - e).abs().max()) / max(largest[n], 1e-300),
                        limit_errs(a, e, *tol)[1])
                    for n, a, e in zip(names, outs, exact)}
        kernel_f64, plain_f64 = from_exact(kernels), from_exact(plain)
        del kernels, plain, plain_o
        s_max, p_max = softmax_peak(torch, q, k, causal, scale)
        row = dict(call=i, q=list(q.shape), kv=list(k.shape), causal=causal, dtype=dt,
                   score_max=s_max, softmax_peak=p_max, do_gain=gain, largest=largest,
                   share={n: kernel_f64[n][0] for n in names},
                   plain_share={n: plain_f64[n][0] for n in names},
                   limit_use_vs_plain=vs_plain,
                   limit_use_from_f64={n: kernel_f64[n][1] for n in names},
                   plain_limit_use_from_f64={n: plain_f64[n][1] for n in names},
                   moved=moved, one_step=one_step,
                   moved_vs_one_step=moved / max(one_step, 1e-30))
        print(f"{label}, init weights, flash call {i} q={row['q']} kv={row['kv']} {dt} "
              f"causal={causal}: scores up to {s_max:.4g}, a row's largest softmax weight "
              f"{p_max:.4f} on average; dO x {gain:.4g}; from the float64 result, "
              f"max|a-e|/max|e| kernels / plain (tol {ONE_HOT_SHARE:.4g}): "
              + ", ".join(f"{n} {kernel_f64[n][0]:.3g} / {plain_f64[n][0]:.3g}" for n in names)
              + f"; of the {dt} elementwise limit, kernels against the plain versions "
              f"{vs_plain:.4g}, from float64 kernels / plain "
              + ", ".join(f"{n} {kernel_f64[n][1]:.4g} / {plain_f64[n][1]:.4g}" for n in names)
              + f"; o moved {moved:.4g} from the plain output, "
              f"{row['moved_vs_one_step']:.3g}x one float32 step's {one_step:.4g}")
        if elementwise and dt == "bfloat16":
            row["emulated"] = split_readings(torch, q, k, v, o, do, lse, causal, scale,
                                             exact_kernels)
            print_split_readings(f"{label}, init weights, flash call {i}",
                                 row["limit_use_from_f64"], row["emulated"])
        rows.append(row)
        for n in names:
            if kernel_f64[n][0] > ONE_HOT_SHARE:
                missed.append(f"call {i}: {n} is {kernel_f64[n][0]:.4g} of its largest "
                              f"element from float64")
            if elementwise and kernel_f64[n][1] > 1.0:
                missed.append(f"call {i}: {n} is {kernel_f64[n][1]:.4g} of the {dt} "
                              f"elementwise limit from float64")
        del ours, do, exact_kernels
    del calls
    check(not missed, f"{label} init weights: " + "; ".join(missed))
    return rows


def family_grad_check(torch, dev, label: str, arch: str, over: dict,
                      init_only: bool = False, seed: int = 0) -> dict:
    """``arch`` at full width with the depth of ``over``, bfloat16, on B 4 x
    S 256 tokens (whisper with random frames, internvl2 with random patch
    embeddings of the launcher's shape; MoE layers dropless, as the
    launcher trains them): `init_attention_check` on the init rule's
    weights (held at the elementwise limit too for
    `ELEMENTWISE_INIT_FAMILIES`), then, unless ``init_only``, `grad_check`
    of ``registry.loss_fn`` on the same draws rescaled by `fan_in_weights`,
    or on the rule's for `RULE_WEIGHTS_FAMILIES`.  ``seed`` moves every draw: the
    weights from generator ``seed``, the tokens from the data's seed
    ``seed``, the frames or patches from generator `INPUT_SEED` + ``seed``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.convert import to_port_layout
    from repro_torch.device import generator
    from repro_torch.models import registry
    from repro_torch.models.param import spec_leaves, tree_leaves
    from repro_torch.training.data import data_iterator
    from repro_torch.training.train_step import init_params

    cfg = dataclasses.replace(get_config(arch), **over)
    params = init_params(cfg, generator(seed, dev), dev)
    spec = registry.abstract_params(cfg)
    names = ["/".join(p) for p, _ in spec_leaves(spec)]
    batch = next(data_iterator(cfg.vocab_size, 4, 256, seed=seed))
    batch = {k: torch.as_tensor(v, dtype=torch.long, device=dev) for k, v in batch.items()}
    front = {"audio": ("frames", cfg.frontend_tokens),
             "vlm": ("patch_embeds", min(cfg.frontend_tokens, 256))}.get(cfg.family)
    if front:
        batch[front[0]] = torch.randn((4, front[1], cfg.d_model),
                                      generator=generator(INPUT_SEED + seed, dev), device=dev
                                      ).to(getattr(torch, cfg.dtype))
    depth = ", ".join(f"{k} {v}" for k, v in over.items())
    label = f"{label} grad check: {arch} full width, {depth}, B 4 S 256 {cfg.dtype}"
    dropless = cfg.num_experts > 0

    def loss_of():
        return registry.loss_fn(to_port_layout(params), batch, cfg, dropless=dropless)[0]
    want = train_attention_calls(cfg)
    init = init_attention_check(torch, label, loss_of, tree_leaves(params), want,
                                elementwise=arch in ELEMENTWISE_INIT_FAMILIES)
    if init_only:
        del params, batch
        return dict(init_attention=init)
    fan_in = arch not in RULE_WEIGHTS_FAMILIES
    if fan_in:
        fan_in_weights(torch, params, spec)
    out = grad_check(torch, f"{label}, {'fan-in' if fan_in else 'init'} weights", loss_of,
                     tree_leaves(params), names, want, yardstick=dropless)
    out.update(weights="fan_in" if fan_in else "init", init_attention=init)
    del params, batch
    return out


def wan_grad_check(torch, dev) -> dict:
    """Wan's ``diffusion_loss`` at ``PORT`` (2 DiT layers, every width, B 1,
    float32; weights from generator 0, latent tokens, text embeddings, the
    timestep and the noise from generator `INPUT_SEED`, the last two passed
    in so that every run sees the same draws): `init_attention_check` on the
    init rule's weights, `grad_check` at WAN_LOSS_RTOL and WAN_GRAD_SHARE on
    the same draws rescaled by `fan_in_weights`, then one more loss and
    gradient through the kernels under `profile_steps`: the flash
    backward's share of the device time."""
    from repro_torch.configs.wan_i2v import PORT
    from repro_torch.convert import to_port_layout
    from repro_torch.device import generator
    from repro_torch.models.aigc import dit
    from repro_torch.models.param import init_tree, spec_leaves, tree_leaves
    from repro_torch.training.train_step import trainable

    spec = dit.abstract_params(PORT)
    params = trainable(init_tree(spec, generator(0, dev), dev))
    leaves = tree_leaves(params)
    names = ["/".join(p) for p, _ in spec_leaves(spec)]
    gen = generator(INPUT_SEED, dev)
    pd = PORT.patch ** 2 * PORT.vae_latent_ch
    z = torch.randn((1, PORT.video_tokens, pd), generator=gen, device=dev)
    text = torch.randn((1, PORT.text_len, PORT.text_d_model), generator=gen, device=dev)
    t = torch.randint(0, 1000, (1,), generator=gen, device=dev)
    noise = torch.randn(z.shape, generator=gen, device=dev)

    def loss_of():
        return dit.diffusion_loss(to_port_layout(params), z, text, PORT, t=t, noise=noise)
    label = (f"wan grad check: diffusion_loss at PORT ({PORT.dit_layers} DiT layers, "
             f"{PORT.dit_d_model} wide, {PORT.dit_heads} heads, {PORT.video_tokens} tokens over "
             f"{PORT.text_len} text keys), float32, t {int(t[0])}")
    want = train_attention_calls(PORT)
    init = init_attention_check(torch, label, loss_of, leaves, want)
    gc.collect()
    torch.cuda.empty_cache()
    fan_in_weights(torch, params, spec)
    out = grad_check(torch, f"{label}, fan-in weights", loss_of, leaves, names, want,
                     WAN_LOSS_RTOL, WAN_GRAD_SHARE)
    out.update(weights="fan_in", init_attention=init)
    prof = profile_steps(torch, lambda i: torch.autograd.grad(loss_of(), leaves), 1,
                         "wan grad profile: one loss and gradient through the kernels")
    busy = prof["busy_ms"]
    bwd = prof["by_kind_ms"].get("flash backward", 0.0)
    print(f"wan grad profile: the flash backward {bwd:.2f} ms of {busy:.2f} ms device time "
          f"({bwd / busy:.1%}), the flash forward "
          f"{prof['by_kind_ms'].get('flash forward', 0.0):.2f} ms")
    out.update(profile=prof, flash_bwd_share=bwd / busy)
    del params, leaves
    return out


def vae_grad_check(torch, dev) -> dict:
    """Wan's ``vae_loss`` at ``PORT``'s widths (480 x 480 frames, 96 base
    channels, 16 latent channels), float32, for VAE_FRAMES frames with the
    noise passed in: one loss and gradient on the card against the same
    call of the port on the CPU, on the same weights (generator 0 on the
    CPU, by the init rule, then rescaled by `fan_in_weights`) and inputs,
    the loss within WAN_LOSS_RTOL relative and each leaf within
    WAN_GRAD_SHARE of its largest element.  It runs no kernel of the port
    (convolutions in ATen, without cuDNN: ``vae._conv2d``)."""
    from repro_torch.configs.wan_i2v import PORT
    from repro_torch.convert import to_port_layout
    from repro_torch.device import generator
    from repro_torch.models.aigc import vae
    from repro_torch.models.param import init_tree, spec_leaves, tree_leaves, tree_map
    from repro_torch.training.train_step import trainable

    spec = vae.abstract_params(PORT)
    names = ["/".join(p) for p, _ in spec_leaves(spec)]
    cpu = trainable(init_tree(spec, generator(0, "cpu"), "cpu"))
    gen = generator(INPUT_SEED, "cpu")
    frames = torch.rand((VAE_FRAMES, PORT.image_size, PORT.image_size, 3), generator=gen) * 2 - 1
    hl = PORT.latent_size
    noise = torch.randn((VAE_FRAMES, hl, hl, PORT.vae_latent_ch), generator=gen)
    out = {}
    for weights in ("init", "fan_in"):
        if weights == "fan_in":
            fan_in_weights(torch, cpu, spec)
        card = trainable(tree_map(lambda p: p.detach().to(dev), cpu))
        runs = {}
        for where, params in (("card", card), ("cpu", cpu)):
            d = dev if where == "card" else torch.device("cpu")
            if where == "card":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, parts = vae.vae_loss(to_port_layout(params), frames.to(d), PORT,
                                       noise=noise.to(d))
            grads = torch.autograd.grad(loss, tree_leaves(params))
            if where == "card":
                torch.cuda.synchronize()
            runs[where] = (float(loss.detach()), [g.cpu() for g in grads],
                           1e3 * (time.perf_counter() - t0),
                           torch.cuda.max_memory_allocated() / 2 ** 30 if where == "card"
                           else None, {k: float(v.detach()) for k, v in parts.items()})
        del card
        (loss_c, grads_c, wall_c, peak, parts_c), (loss_h, grads_h, wall_h, _, _) = (
            runs["card"], runs["cpu"])
        label = f"vae grad check {weights} weights"
        shares = leaf_shares(torch, label, names, grads_c, grads_h)
        loss_rel = abs(loss_c - loss_h) / abs(loss_h)
        worst = max(shares, key=shares.get)
        print(f"{label}: vae_loss at PORT's widths ({VAE_FRAMES} frames of "
              f"{PORT.image_size}x{PORT.image_size}, base {PORT.vae_base_ch}, latent "
              f"{PORT.vae_latent_ch}), float32: loss card {loss_c:.7g} cpu {loss_h:.7g} (rel "
              f"{loss_rel:.3g}, tol {WAN_LOSS_RTOL}; rec {parts_c['rec']:.6g}, kl "
              f"{parts_c['kl']:.6g}); {len(shares)} gradient leaves, largest max|a-b|/max|b| "
              f"{shares[worst]:.4g} at {worst} (tol {WAN_GRAD_SHARE}), median "
              f"{statistics.median(shares.values()):.4g}; card wall {wall_c:.1f} ms, peak "
              f"{peak:.2f} GiB; cpu wall {wall_h:.1f} ms")
        for name in sorted(shares):
            print(f"  {label} {name}: {shares[name]:.4g}")
        check(loss_rel <= WAN_LOSS_RTOL, f"{label}: the losses differ")
        check(shares[worst] <= WAN_GRAD_SHARE, f"{label}: {worst} differs")
        out[weights] = dict(loss_card=loss_c, loss_cpu=loss_h, loss_rel=loss_rel,
                            worst_leaf=worst, worst_share=shares[worst], wall_ms=wall_c,
                            cpu_wall_ms=wall_h, peak_gib=peak, frames=VAE_FRAMES, **parts_c)
    return out


def train_run(torch, dev, argv=TRAIN_ARGS) -> dict:
    """A model through ``launch.train`` (its ``train``, as ``main`` runs it;
    qwen3-1.7b at full width and depth unless ``argv`` says otherwise): the
    launch counters set to 0 just before and read just after; ce finite and
    falling, the model's kernels launched: flash attention's
    `train_attention_calls` a step, or for rwkv6 WKV6's (2 forward per layer
    and step: the forward and its recompute under checkpointing; 1
    backward) and no flash kernel."""
    from repro_torch.kernels import (flash_attention, flash_attention_backward, wkv6,
                                     wkv6_backward)
    from repro_torch.launch import train as launcher

    args = launcher.parser().parse_args(argv)
    torch.cuda.empty_cache()
    counters = (flash_attention, flash_attention_backward, wkv6, wkv6_backward)
    for c in counters:
        c.launches = 0
    out = launcher.train(args)
    fwd, bwd, wf, wb = (c.launches for c in counters)
    cfg, ces = out["cfg"], out["ce"]
    steady = sorted(out["step_s"][1:])
    step_ms = 1e3 * steady[len(steady) // 2]
    tokens = args.batch * args.seq
    reckoning = state_reckoning_gib(cfg)
    res = dict(arch=args.arch, preset=args.preset, dtype=cfg.dtype, layers=cfg.num_layers,
               ce_first=ces[0], ce_last=ces[-1], steps=args.steps, batch=args.batch,
               seq=args.seq, step_ms=step_ms, first_step_ms=1e3 * out["step_s"][0],
               tokens_per_s=tokens / (step_ms / 1e3),
               launcher_tokens_per_s=out["tokens_per_s"],
               peak_gib=out["peak_bytes"] / 2 ** 30, reckoning_gib=reckoning,
               flash_launches=fwd, flash_bwd_launches=bwd, wkv6_launches=wf,
               wkv6_bwd_launches=wb)
    recurrent = cfg.family == "ssm"
    kf, kb, name = (wf, wb, "wkv6") if recurrent else (fwd, bwd, "flash")
    depth = (f"{cfg.encoder_layers} encoder and {cfg.num_layers} decoder"
             if cfg.family == "audio" else f"{cfg.num_layers}")
    print(f"train {args.arch} {args.preset} ({depth} layers, {cfg.dtype}): ce "
          f"{ces[0]:.4f} -> {ces[-1]:.4f} in {args.steps} steps of {args.batch}x{args.seq}; "
          f"step {step_ms:.1f} ms (median after the first, {res['first_step_ms']:.0f} ms), "
          f"{res['tokens_per_s']:.0f} tokens/s, peak {res['peak_gib']:.2f} GiB (weights, "
          f"gradients and moments reckoned {reckoning:.2f} GiB); launches "
          f"{name} {kf} ({kf / args.steps:.0f} a step) backward {kb} "
          f"({kb / args.steps:.0f} a step)" + (f", flash {fwd + bwd}" if recurrent else ""))
    check(all(math.isfinite(c) for c in ces), "train: non-finite ce")
    check(ces[-1] < ces[0], f"train: ce did not fall ({ces[0]} -> {ces[-1]})")
    held_launches("train", cfg, args.steps, (fwd, bwd, wf, wb))
    return res


def state_reckoning_gib(cfg) -> float:
    """GiB of ``cfg``'s weights and gradients in its dtype and its two
    float32 moments: 12 bytes a bfloat16 parameter, 16 a float32 one."""
    from repro_torch.models import registry

    item = 2 if cfg.dtype == "bfloat16" else 4
    return registry.count_params(cfg) * (2 * item + 8) / 2 ** 30


def held_launches(label: str, cfg, steps: int, counts) -> None:
    """``counts`` (flash forward, flash backward, WKV6 forward, WKV6
    backward) of ``steps`` training steps of ``cfg``: for rwkv6 2 forward
    and 1 backward WKV6 launches a layer and step and no flash kernel, for
    every other family `train_attention_calls` a step and no WKV6."""
    fwd, bwd, wf, wb = counts
    if cfg.family == "ssm":
        want, ok = (2 * cfg.num_layers * steps, cfg.num_layers * steps), (fwd, bwd) == (0, 0)
        got = (wf, wb)
    else:
        want = tuple(n * steps for n in train_attention_calls(cfg))
        ok, got = (wf, wb) == (0, 0), (fwd, bwd)
    check(got == want and ok, f"{label}: launches flash {fwd}, backward {bwd}; wkv6 {wf}, "
                              f"backward {wb}; {'wkv6' if cfg.family == 'ssm' else 'flash'} "
                              f"expected {want}")


def train_steps(torch, dev, arch: str, layers: int, steps: int, profiled: int = 0) -> dict:
    """``arch`` at full width and ``layers`` of its layers in bfloat16,
    ``steps`` AdamW steps through ``make_train_step`` (as `train_profile`
    drives it; MoE layers dropless, as the launcher trains them) of B 4 x
    S 256 tokens of the bigram chain over 1,024 ids at lr 1e-3, the launch
    counters set to 0 just before and read just after: ce finite and
    falling, the launches of `held_launches`; step time (median after the
    first), tokens/s, the peak memory beside `state_reckoning_gib`; then
    ``profiled`` more steps under `profile_steps`."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.device import generator
    from repro_torch.kernels import (flash_attention, flash_attention_backward, wkv6,
                                     wkv6_backward)
    from repro_torch.models.param import tree_leaves
    from repro_torch.training import adamw_init, make_train_step
    from repro_torch.training.data import data_iterator
    from repro_torch.training.train_step import init_params

    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers)
    torch.cuda.empty_cache()
    params = init_params(cfg, generator(0, dev), dev)
    opt = adamw_init(params)
    step = make_train_step(cfg, lr=1e-3, dropless=cfg.num_experts > 0)
    data = data_iterator(1024, 4, 256, seed=0)
    batches = [{k: torch.as_tensor(v, dtype=torch.long, device=dev)
                for k, v in next(data).items()} for _ in range(steps + profiled)]
    n_params = sum(p.numel() for p in tree_leaves(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = (flash_attention, flash_attention_backward, wkv6, wkv6_backward)
    for c in counters:
        c.launches = 0
    ces, step_s = [], []
    for b in batches[:steps]:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        ces.append(float(m["ce"]))
        step_s.append(time.perf_counter() - t0)
    fl, flb, wf, wb = counts = tuple(c.launches for c in counters)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reckoning = state_reckoning_gib(cfg)
    steady = sorted(step_s[1:])
    step_ms = 1e3 * steady[len(steady) // 2]
    tokens = 4 * 256
    kf, kb, name, other = ((wf, wb, "wkv6", f"flash {fl + flb}") if cfg.family == "ssm"
                           else (fl, flb, "flash", f"wkv6 {wf + wb}"))
    label = f"train {arch}"
    print(f"{label} full width ({layers} of {full.num_layers} layers, {n_params / 1e9:.2f} B "
          f"params, bfloat16) through make_train_step: ce {ces[0]:.4f} -> {ces[-1]:.4f} "
          f"in {steps} steps of 4x256; step {step_ms:.1f} ms (median after the first, "
          f"{1e3 * step_s[0]:.0f} ms), {tokens / (step_ms / 1e3):.0f} tokens/s, peak "
          f"{peak:.2f} GiB (weights, gradients and moments reckoned {reckoning:.2f} GiB); "
          f"launches {name} {kf} ({kf / steps:.0f} a step) backward {kb} "
          f"({kb / steps:.0f} a step), {other}")
    check(all(math.isfinite(c) for c in ces), f"{label}: non-finite ce")
    check(ces[-1] < ces[0], f"{label}: ce did not fall ({ces[0]} -> {ces[-1]})")
    held_launches(label, cfg, steps, counts)
    out = dict(arch=arch, layers=layers, dtype="bfloat16", params=n_params,
               ce_first=ces[0], ce_last=ces[-1], ces=ces, steps=steps, batch=4, seq=256,
               step_ms=step_ms, first_step_ms=1e3 * step_s[0],
               tokens_per_s=tokens / (step_ms / 1e3), peak_gib=peak,
               reckoning_gib=reckoning, flash_launches=fl, flash_bwd_launches=flb,
               wkv6_launches=wf, wkv6_bwd_launches=wb)
    if profiled:
        state = [params, opt]

        def run_step(i):
            state[:] = step(*state, batches[steps + i])[:2]
        out["profile"] = profile_steps(torch, run_step, profiled,
                                       f"train profile {arch} ({layers} layers)")
        del state
    del params, opt
    return out


#: kernel name -> kind, for the training step's device-time breakdown (the
#: first key a name holds decides)
STEP_KINDS = (("wkv6_bwd", "wkv6 backward"), ("wkv6_chunked", "wkv6 forward"),
              ("bwd_", "flash backward"), ("flash_fwd", "flash forward"),
              ("gemm", "matrix products"), ("xmma", "matrix products"),
              ("cutlass", "matrix products"), ("nvjet", "matrix products"),
              ("reduce", "reductions"), ("elementwise", "elementwise"),
              ("vectorized", "elementwise"))


def profile_steps(torch, run_step, steps: int, label: str) -> dict:
    """``steps`` calls of ``run_step(i)`` under ``torch.profiler``: the
    kernels' summed device time a step by kind (`STEP_KINDS`, by name), the
    device's busy share of the wall, the kernels a step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            run_step(i)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    kinds, launches = {}, 0
    for e in prof.key_averages():
        if e.device_type.name != "CUDA":
            continue
        kind = next((k for key, k in STEP_KINDS if key in e.key), "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.self_device_time_total / 1e3 / steps
        launches += e.count
    busy = sum(kinds.values())
    check(busy > 0, f"{label}: the profiler saw no device time")
    print(f"{label}: a step {wall_ms:.1f} ms wall under the profiler, device busy "
          f"{busy:.1f} ms ({busy / wall_ms:.1%}), {launches / steps:.0f} kernels a step: "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in sorted(kinds.items(), key=lambda x: -x[1])))
    return dict(wall_ms=wall_ms, busy_ms=busy, kernels_per_step=launches / steps,
                by_kind_ms=kinds)


def train_profile(torch, dev, steps: int = 2) -> dict:
    """Where a qwen3-1.7b training step's device time goes: one warm-up
    step, then ``steps`` under `profile_steps`."""
    from repro_torch.launch import train as launcher
    from repro_torch.device import generator
    from repro_torch.training import adamw_init, make_train_step
    from repro_torch.training.data import data_iterator
    from repro_torch.training.train_step import init_params

    args = launcher.parser().parse_args(TRAIN_ARGS)
    cfg = launcher.build_config(args.arch, args.preset)
    params = init_params(cfg, generator(args.seed, dev), dev)
    opt = adamw_init(params)
    step = make_train_step(cfg, lr=args.lr)
    data = data_iterator(args.data_vocab or cfg.vocab_size, args.batch, args.seq,
                         seed=args.seed)
    batches = [{k: torch.as_tensor(v, dtype=torch.long, device=dev)
                for k, v in next(data).items()} for _ in range(steps + 1)]
    state = list(step(params, opt, batches[0])[:2])

    def run_step(i):
        state[:] = step(*state, batches[i + 1])[:2]
    out = profile_steps(torch, run_step, steps, "train profile")
    del params, opt, state
    return out


def bf16_numerics(torch, F, dev, randn, lib_path) -> dict:
    """``--only bf16_numerics``: the bfloat16 flash kernels' builds, their
    `FROM_F64_CASES` forward and backward, and the init rule's flash calls
    of `ELEMENTWISE_INIT_FAMILIES` (`init_attention_check` alone), each
    with the kernels' arithmetic emulated beside; every part runs, then the
    mode fails if one did."""
    out, failed = {}, []
    parts = (
        ("fwd_build", partial(flash_build_report, lib_path, "flash_fwd_bf16")),
        ("bwd_build", partial(flash_bwd_build_report, lib_path)),
        ("fwd", partial(flash_bf16_phase, torch, F, dev, randn, FROM_F64_CASES)),
        ("bwd", partial(flash_bwd_kernel_phase, torch, F, dev, randn, FROM_F64_CASES)),
        ("qwen3", partial(family_grad_check, torch, dev, "train", "qwen3-1.7b",
                          dict(num_layers=GRAD_CHECK_LAYERS), init_only=True)),
        ("zamba2", partial(family_grad_check, torch, dev, "zamba2", "zamba2-1.2b",
                           FAMILY_GRAD_CHECKS["zamba2"][1], init_only=True)),
        ("gemma3", partial(family_grad_check, torch, dev, "gemma3", "gemma3-27b",
                           FAMILY_GRAD_CHECKS["gemma3"][1], init_only=True)))
    for key, fn in parts:
        try:
            out[key] = fn()
        except SystemExit as e:
            failed.append(str(e))
        gc.collect()
        torch.cuda.empty_cache()
    check(not failed, " | ".join(failed))
    return out


def train_phase(torch, F, np, dev, randn, lib_path) -> dict:
    """The training phase (``--only train``): the backward kernels' builds
    and cases (flash attention's, then WKV6's), the full-width gradient
    checks, the full runs, then the runs at a cut depth."""
    build = flash_bwd_build_report(lib_path)
    rows = flash_bwd_kernel_phase(torch, F, dev, randn)
    wkv_build = wkv6_bwd_build_report(lib_path)
    wkv_rows = wkv6_bwd_kernel_phase(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    out = dict(build=build, rows=rows, wkv6_build=wkv_build, wkv6_rows=wkv_rows)
    steps = [
        # qwen3's end to end on the init rule's weights (`RULE_WEIGHTS_FAMILIES`)
        ("grad_check", partial(family_grad_check, torch, dev, "train", "qwen3-1.7b",
                               dict(num_layers=GRAD_CHECK_LAYERS))),
        ("run", partial(train_run, torch, dev)),
        ("profile", partial(train_profile, torch, dev)),
        ("run_f32", partial(train_run, torch, dev, TRAIN_F32_ARGS)),
        ("rwkv6_grad_check", partial(rwkv6_grad_check, torch, dev)),
        ("rwkv6_run", partial(train_steps, torch, dev, "rwkv6-7b", RWKV_TRAIN_LAYERS,
                              RWKV_TRAIN_STEPS, PROFILED_STEPS)),
        ("rwkv6_run_f32", partial(train_run, torch, dev, RWKV_TRAIN_F32_ARGS)),
        ("wan_grad_check", partial(wan_grad_check, torch, dev)),
        ("vae_grad_check", partial(vae_grad_check, torch, dev))]
    for label, (arch, over) in FAMILY_GRAD_CHECKS.items():
        run = (partial(train_run, torch, dev, FAMILY_TRAIN_ARGS[arch]) if arch in FAMILY_TRAIN_ARGS
               else partial(train_steps, torch, dev, arch, FAMILY_TRAIN_DEPTHS[arch],
                            FAMILY_TRAIN_STEPS))
        steps += [(f"{label}_grad_check", partial(family_grad_check, torch, dev, label, arch, over)),
                  (f"{label}_run", run)]
    for key, fn in steps:
        out[key] = fn()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _tap(fn, workflow, store, request_seeds):
    def tapped(p):
        out = fn(p)
        lat = out["latents"]
        for s, row in zip(request_seeds(p["seed"], lat.shape[0]), lat):
            store[(workflow, s)] = row
        return out
    return tapped


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _to64(torch, tree):
    """A parameter tree with every floating leaf in float64."""
    if isinstance(tree, dict):
        return {k: _to64(torch, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to64(torch, v) for v in tree]
    return tree.double() if tree.is_floating_point() else tree


def _to(torch, tree, dev):
    if isinstance(tree, dict):
        return {k: _to(torch, v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(torch, v, dev) for v in tree]
    return tree.to(dev)



#: zamba2-1.2b's SSD scan: (label, B, T, with gradients).  The served
#: prefill's shape (one prompt of 256 tokens: the coalescer's rows run one
#: at a time) and the training run's (B 4, S 256); H 64, P 64, N 64.
SSD_CASES = [("served_1x256", 1, 256, False), ("train_4x256", 4, 256, True)]
SSD_HEADS, SSD_HEAD_DIM, SSD_STATE = 64, 64, 64
#: y elementwise at the float32 limit |a - b| <= 2e-5 |b| + 2e-5, the state
#: at 1e-4 (the CPU tests' limits); a gradient leaf within 2e-5 of its
#: largest element: its elements sum 64-4096 terms, and no float32 order
#: meets the elementwise limit from float64 there (the step loop's dt, log
#: a, B and C gradients read 0.8-1.6 of it on the CPU at these shapes)
SSD_TOL, SSD_STATE_TOL = 2e-5, 1e-4


def ssd_step_loop(torch, x, dt, la, B, C, state):
    """The recurrence as the port ran it before the chunked form: one
    ``mamba2.ssd_step`` a position, the decays exp(la)."""
    from repro_torch.models import mamba2

    a, ys = torch.exp(la), []
    for t in range(x.shape[1]):
        y, state = mamba2.ssd_step(x[:, t], dt[:, t], a[:, t], B[:, t], C[:, t], state)
        ys.append(y)
    return torch.stack(ys, dim=1), state


def ssd_phase(torch, dev) -> list:
    """zamba2-1.2b's SSD scan in the chunked form (``mamba2.ssd_scan_log``,
    plain PyTorch in float32, TF32 off) against the step loop it replaced
    (`ssd_step_loop`) on the card, at `SSD_CASES`: y and the end state, and
    at the training shape the gradients of x, dt, the log-decays, B, C and
    the start state (each form differentiated by autograd); both forms'
    distance from the chunked form in float64 is printed beside.  Inputs as
    ``tests/test_torch_zamba2.py`` draws them: dt softplus of N(0, 1), the
    log-decay -dt exp(0.5 N(0, 1)) a head.  Times: the median of 5 calls
    between CUDA events (forward, or forward and backward)."""
    from repro_torch.models import mamba2

    rows = []
    for label, b, t, grad in SSD_CASES:
        h, p, n = SSD_HEADS, SSD_HEAD_DIM, SSD_STATE
        gen = torch.Generator(device=dev).manual_seed(3)

        def r(*shape):
            return torch.randn(shape, generator=gen, device=dev, dtype=torch.float64)

        dt = torch.nn.functional.softplus(r(b, t, h))
        args64 = [r(b, t, h, p), dt, -dt * torch.exp(0.5 * r(h)), r(b, t, n), r(b, t, n),
                  0.5 * r(b, h, p, n)]
        gy, gs = r(b, t, h, p), r(b, h, p, n)
        args = [v.float() for v in args64]

        def run(fn, xs, backward):
            leaves = [v.clone().requires_grad_(backward) for v in xs]
            y, s = fn(*leaves)
            if backward:
                ((y * gy.to(y.dtype)).sum() + (s * gs.to(s.dtype)).sum()).backward()
            return y.detach(), s.detach(), [v.grad for v in leaves]

        def loop(*xs):
            return ssd_step_loop(torch, *xs)

        chunked, plain = (run(fn, args, grad) for fn in (mamba2.ssd_scan_log, loop))
        exact = run(mamba2.ssd_scan_log, args64, grad)
        torch.cuda.synchronize()

        def elem(a, ref, tol):
            return float(((a.double() - ref.double()).abs()
                          / (tol + tol * ref.double().abs())).max())

        def by_max(a, ref, tol):
            return float((a.double() - ref.double()).abs().max()
                         / (tol + tol * ref.double().abs().max()))

        row = dict(shape=label, b=b, t=t, h=h, p=p, n=n, gradients=grad,
                   y_limit_use=elem(chunked[0], plain[0], SSD_TOL),
                   state_limit_use=elem(chunked[1], plain[1], SSD_STATE_TOL),
                   y_from_f64=[elem(f[0], exact[0], SSD_TOL) for f in (chunked, plain)],
                   finite=all(bool(torch.isfinite(v).all()) for v in chunked[:2]))
        if grad:
            names = ("x", "dt", "log_a", "B", "C", "state")
            row["grad_leaf_use"] = {k: by_max(a, b_, SSD_TOL)
                                    for k, a, b_ in zip(names, chunked[2], plain[2])}
            row["grad_elementwise_from_f64"] = {
                k: [elem(f[2][i], exact[2][i], SSD_TOL) for f in (chunked, plain)]
                for i, k in enumerate(names)}
            row["finite"] = row["finite"] and all(bool(torch.isfinite(g).all())
                                                  for g in chunked[2])
        ms = {}
        for name, fn in (("chunked", mamba2.ssd_scan_log), ("loop", loop)):
            ms[name] = statistics.median(cuda_times(torch, lambda: run(fn, args, grad), 5))
        row.update(ms=ms["chunked"], loop_ms=ms["loop"])
        rows.append(row)
        extra = ""
        if grad:
            extra = ("; gradients, of each leaf's largest element: " + ", ".join(
                f"{k} {v:.4f}" for k, v in row["grad_leaf_use"].items())
                + "; elementwise from float64 (chunked, loop): " + ", ".join(
                f"{k} {a:.2f}/{b_:.2f}" for k, (a, b_) in row["grad_elementwise_from_f64"].items()))
        print(f"ssd {label} [B {b}, T {t}, H {h}, P {p}, N {n}] chunked against the step "
              f"loop: y {row['y_limit_use']:.4f} of the f32 limit, state "
              f"{row['state_limit_use']:.4f} of 1e-4; y from float64 (chunked, loop) "
              f"{row['y_from_f64'][0]:.3f}/{row['y_from_f64'][1]:.3f}{extra}; "
              f"{'forward and backward' if grad else 'forward'} ms chunked={ms['chunked']:.3f} "
              f"loop={ms['loop']:.3f} ({ms['loop'] / ms['chunked']:.1f}x)")
        check(row["finite"], f"ssd {label}: the chunked form gave a value not finite")
        check(row["y_limit_use"] <= 1.0 and row["state_limit_use"] <= 1.0,
              f"ssd {label}: the chunked form differs from the step loop: {row}")
        if grad:
            check(max(row["grad_leaf_use"].values()) <= 1.0,
                  f"ssd {label}: a gradient of the chunked form differs from the step "
                  f"loop's: {row['grad_leaf_use']}")
    return rows


#: The production dry-run cases of the sharding phase, each traced at 16x16
#: in a subprocess on the CPU (the card hidden): (arch, shape).
DRYRUN_CASES = [("qwen3-1.7b", "train_4k"), ("qwen3-1.7b", "prefill_32k"),
                ("qwen3-1.7b", "decode_32k"), ("deepseek-moe-16b", "train_4k"),
                ("rwkv6-7b", "long_500k"), ("zamba2-1.2b", "prefill_32k")]
#: The sharded checks on the card's 1x1 mesh: name -> (arch, layers or None
#: for the full depth, check, its arguments).  deepseek-moe-16b runs its
#: capacity branch (``moe_ffn``), sharded through ``local_map``.
SHARDED_CHECKS = [
    ("qwen3-1.7b", "qwen3-1.7b", None, "inference",
     dict(batch=4, prompt=512, max_len=520, steps=8)),
    ("deepseek-moe-16b", "deepseek-moe-16b", 8, "inference",
     dict(batch=4, prompt=512, max_len=516, steps=4)),
    ("rwkv6-7b", "rwkv6-7b", None, "inference",
     dict(batch=4, prompt=512, max_len=516, steps=4)),
    ("qwen3-1.7b train", "qwen3-1.7b", None, "train", dict(batch=4, seq=256)),
]


def sharding_phase(torch) -> dict:
    """The sharding phase (``--only sharding``): (b) the six production
    dry-run cases, started first, each in a subprocess on the CPU with the
    card hidden (fake tensors over a fake process group of 256); (a) on the
    card's 1x1 mesh (NCCL, world size 1) each model of `SHARDED_CHECKS` with
    DTensor weights, cache and inputs against the unsharded port on the same
    weights, bit for bit, the kernels' launches counted over the sharded runs
    alone.  Then the dry-run cases' figures: each exits 0 and launches
    nothing."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.configs import H100, get_config
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.shard_check import check_inference, check_train_step

    total = torch.cuda.get_device_properties(0).total_memory
    print(f"sharding: configs.H100.hbm_bytes={H100.hbm_bytes:.0f}, the card's "
          f"total_memory={total}")
    check(H100.hbm_bytes == total, "configs.H100.hbm_bytes is not this card's capacity")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    out_dir = os.path.join(ROOT, "build", "dryrun_torch")
    t0 = time.perf_counter()
    procs = [(case, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", case[0], "--shape",
         case[1], "--out", out_dir], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)) for case in DRYRUN_CASES]
    names = ("flash_attention", "flash_attention_backward", "decode_attention_grouped",
             "decode_attention_int8_grouped", "wkv6", "wkv6_backward")

    def zero():
        torch.cuda.synchronize()
        for n in names:
            getattr(kernels, n).launches = 0

    lse_check = decode_lse_check(torch)
    mesh = make_smoke_mesh("cuda")
    results = {}
    try:
        for label, arch, layers, kind, kw in SHARDED_CHECKS:
            cfg = get_config(arch)
            if layers:
                cfg = dataclasses.replace(cfg, num_layers=layers)
            t1 = time.perf_counter()
            fn = check_inference if kind == "inference" else check_train_step
            res = fn(cfg, mesh, device="cuda", on_sharded=zero, **kw)
            torch.cuda.synchronize()
            launches = {n: getattr(kernels, n).launches for n in names}
            rows = res.values() if kind == "inference" else [
                res["loss"], res["grad_norm"], res["params"]]
            equal = all(r["equal"] for r in rows)
            worst = max(r["max_abs"] for r in rows)
            print(f"sharding 1x1 {label} ({cfg.num_layers} layers, {cfg.dtype}, {kw}): "
                  f"sharded against unsharded equal bit for bit: {equal} (max_abs "
                  f"{worst:.3g}); launches in the sharded run {launches}; "
                  f"{time.perf_counter() - t1:.1f}s")
            check(equal, f"sharding 1x1 {label}: the sharded outputs differ from the "
                         f"unsharded ones: {res}")
            results[label] = dict(result=res, launches=launches)
            gc.collect()
            torch.cuda.empty_cache()
    except BaseException:
        for _, p in procs:
            p.kill()
        raise
    finally:
        dist.destroy_process_group()
    inf = [r["launches"] for k, r in results.items() if "train" not in k]
    sharded = {"flash_attention": sum(x["flash_attention"] for x in inf),
               "decode_attention_grouped": sum(x["decode_attention_grouped"] for x in inf),
               "wkv6": results["rwkv6-7b"]["launches"]["wkv6"],
               "train_flash_attention": results["qwen3-1.7b train"]["launches"][
                   "flash_attention"],
               "train_flash_attention_backward": results["qwen3-1.7b train"]["launches"][
                   "flash_attention_backward"]}
    print(f"sharding 1x1: launches over the sharded runs {sharded}")
    for k, v in sharded.items():
        check(v > 0, f"sharding 1x1: {k} launched no time in the sharded runs")

    dry = {}
    for (arch, shape), p in procs:
        try:
            so, se = p.communicate(timeout=max(30.0, 600 - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
        check(p.returncode == 0, f"dry-run {arch} {shape} exited {p.returncode}: "
                                 f"{se[-3000:]}")
        row = json.loads(next(ln for ln in so.splitlines() if ln.startswith("{")))
        dry[f"{arch} {shape}"] = row
        print(f"dryrun {arch} {shape} 16x16 (fake tensors, the dry-run's arithmetic "
              f"with configs.H100): per chip flops={row['flops_per_chip']:.4g} "
              f"bytes={row['bytes_per_chip']:.4g} collective_bytes="
              f"{row['collective_bytes_per_chip']:.4g} peak={row['peak_bytes'] / 1e9:.2f} GB "
              f"fits_hbm={row['fits_hbm']} dominant={row['dominant']} "
              f"trace_s={row['trace_s']} launches={sum(row['kernel_launches'].values())}")
        check(sum(row["kernel_launches"].values()) == 0,
              f"dry-run {arch} {shape} launched kernels")
    print(f"sharding: phase took {time.perf_counter() - t0:.1f}s")
    return dict(one_device=results, sharded_launches=sharded, dryrun=dry,
                decode_lse=lse_check)


def decode_lse_check(torch) -> dict:
    """The flash-decode kernel's log-sum-exp, read from its own partials
    (``decode_attention_grouped_lse``, what a cache sharded over its
    sequence combines its shards by), against the plain version's at qwen3's
    served decode shape (bfloat16, KV 8, G 2, D 128, 1024 positions), one row
    with no valid position: its output zeros and its log-sum-exp -inf; the
    other rows' outputs within one bfloat16 step, log-sum-exp within 1e-5
    of 1 + |b| (float32 sums in another order)."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_grouped_lse, decode_lse_ref)

    gen = torch.Generator(device="cuda").manual_seed(5)

    def r(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, kc, vc = r(4, 8, 2, 128), r(4, 8, 1024, 128), r(4, 8, 1024, 128)
    cur = torch.tensor([1023, 300, 0, -1], dtype=torch.int32, device="cuda")
    out, lse = decode_attention_grouped_lse(q, kc, vc, cur)
    ref_out, ref_lse = decode_lse_ref(q, kc, vc, cur)
    torch.cuda.synchronize()
    _, out_use = limit_errs(out[:3], ref_out[:3])
    lse_use = float(((lse[:3] - ref_lse[:3]).abs() / (1e-5 * (1 + ref_lse[:3].abs()))).max())
    empty = bool(torch.isneginf(lse[3]).all() and not out[3].any())
    print(f"sharding: decode log-sum-exp from the kernel's partials against the plain "
          f"version: out {out_use:.3f} of the bf16 limit, lse {lse_use:.3f} of 1e-5 (1 + |b|); "
          f"the row with no valid position gives zeros and -inf: {empty}")
    check(out_use <= 1.0 and lse_use <= 1.0 and empty,
          "decode_attention_grouped_lse differs from decode_lse_ref")
    return dict(out_limit_use=out_use, lse_limit_use=lse_use, empty_row=empty)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

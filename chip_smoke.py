#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. Set-up: float32 matmuls and convolutions in full float32 (TF32 off), the
   kernels built from the sources in this checkout (``nvcc``, ``sm_90a``,
   into ``build/``), and the card's name and power limit from ``nvidia-smi``.
2. Kernels: each hand-written kernel against its plain PyTorch version at
   the shapes the Wan I2V path gives it at the ``PORT`` profile (full
   widths), plus a small causal GQA case and a ragged case for flash
   attention.  For each: the largest absolute error against the stated
   tolerance, the kernel's time (CUDA events, median), the plain version's,
   one PyTorch library call's where one computes the same function, and the
   bound: the larger of bytes over 3.35 TB/s and flops over 67 TFLOP/s
   (float32 outside the tensor cores; H100 SXM data sheet).
3. The port on a small input: the SMALL pipeline's latents and frames on the
   card against the same computation on the CPU (the plain path the CPU
   tests hold against the JAX package), with the same weights and noise.
4. Serving: 2 requests through the chain and 2 through the DAG Workflow Set
   at ``PORT``, one instance per stage.  Every request answered, nothing
   dropped, the launch counters risen by the expected launches per request,
   and one request's frames equal to ``WanI2VPipeline.generate``.
5. A ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {"platform": "gpu", ...}}``.

It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM
F32_FLOPS_PER_S = 67e12        # H100 SXM, float32 outside the tensor cores
#: docs/kernels.md bench tolerances: attention family 1e-4, ddim 1e-5
FLASH_TOL = 1e-4
DDIM_TOL = 1e-5
SERVE_FRAME_TOL = 1e-4         # served vs generate: the same ops on one card
SERVE_LATENT_RTOL = 1e-4       # served vs the pipeline, of the largest latent
SMALL_LATENT_RTOL = 1e-4       # card vs CPU, relative to the largest latent
SMALL_FRAME_TOL = 2e-3         # card vs CPU frames (tanh output, |f| <= 1)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def cuda_times(torch, fn, reps: int, flush=None) -> list:
    """Milliseconds of ``reps`` runs of ``fn``, each by CUDA events, after
    one warm-up; ``flush`` (untimed) runs before each, to start with a cold
    L2."""
    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def kernel_and_plain_ms(torch, kernel, plain, reps: int, flush=None):
    """Median ms of the kernel and of its plain version, timed in turns
    (kernel, plain, plain, kernel) so that drift hits both alike."""
    k = cuda_times(torch, kernel, reps, flush)
    p = cuda_times(torch, plain, reps, flush)
    p += cuda_times(torch, plain, reps, flush)
    k += cuda_times(torch, kernel, reps, flush)
    return statistics.median(k), statistics.median(p)


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch

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
        build_set, make_request, ring_bytes_for, serve, workflow_spec)
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

    t_dim, t_heads = PORT.text_d_model // PORT.text_heads, PORT.text_heads
    d_dim, d_heads = PORT.dit_d_model // PORT.dit_heads, PORT.dit_heads
    n, t_len = PORT.video_tokens, PORT.text_len
    flash_cases = [
        # name, (B, Sq, Sk, H, KV, D), causal, repetitions
        ("text_self", (1, t_len, t_len, t_heads, t_heads, t_dim), False, 10),
        ("dit_self", (1, n, n, d_heads, d_heads, d_dim), False, 3),
        ("dit_cross", (1, n, t_len, d_heads, d_heads, d_dim), False, 5),
        ("causal_gqa", (2, 300, 300, 8, 2, 64), True, 10),
        ("ragged", (1, 1000, 777, 4, 4, 128), False, 10),
    ]
    flash_rows = []
    for name, (b, sq, sk, h, kv, d), causal, reps in flash_cases:
        q, k, v = randn(b, sq, h, d), randn(b, sk, kv, d), randn(b, sk, kv, d)
        out = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = attention_ref(q, k, v, causal=causal)
        err = float((out - ref).abs().max())
        del out, ref
        ms, plain_ms = kernel_and_plain_ms(
            torch, lambda: flash_attention(q, k, v, causal=causal),
            lambda: attention_ref(q, k, v, causal=causal), reps)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        backends = [SDPBackend.EFFICIENT_ATTENTION]
        if b * h * sq * sk * 4 < (1 << 32):
            backends.append(SDPBackend.MATH)

        def library():
            with sdpa_kernel(backends):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=h != kv)
        library_ms = statistics.median(cuda_times(torch, library, reps))
        pairs = sq * (sq + 1) // 2 if causal else sq * sk
        nbytes = 4 * (2 * b * sq * h * d + 2 * b * sk * kv * d)
        bound_ms, bound_by = bound(nbytes, 4.0 * b * h * pairs * d)
        row = dict(shape=name, q=[b, sq, h, d], kv=[b, sk, kv, d], causal=causal,
                   max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms)
        flash_rows.append(row)
        print(f"flash {name:10s} q={row['q']} kv={row['kv']} causal={causal}: "
              f"max_err={err:.3g} (tol {FLASH_TOL}) ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} sdpa_ms={library_ms:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by})")
        check(err <= FLASH_TOL, f"flash {name}: max_err {err} > {FLASH_TOL}")
        del q, k, v, qt, kt, vt

    pd = PORT.patch ** 2 * PORT.vae_latent_ch
    x, eps = randn(1, n, pd), randn(1, n, pd)
    alphas, ts = dit.schedule(PORT.diffusion_steps)
    a_t, a_p = alphas[ts[0]], alphas[ts[1]]
    c1, c2 = ddim_coefs(a_t, a_p)
    out = ddim_step(x, eps, a_t, a_p)
    torch.cuda.synchronize()
    ddim_err = float((out - ddim_step_ref(x, eps, c1, c2)).abs().max())
    scratch = torch.empty(1 << 26, device=dev)  # 256 MB: more than the L2
    flush = scratch.zero_
    ddim_ms, ddim_plain_ms = kernel_and_plain_ms(
        torch, lambda: ddim_step(x, eps, a_t, a_p),
        lambda: ddim_step_ref(x, eps, c1, c2), 25, flush)
    ddim_bound_ms, ddim_bound_by = bound(3 * 4 * x.numel(), 3 * x.numel())
    print(f"ddim  latent     x={list(x.shape)}: max_err={ddim_err:.3g} "
          f"(tol {DDIM_TOL}) ms={ddim_ms:.5f} plain_ms={ddim_plain_ms:.5f} "
          f"library_ms=null bound_ms={ddim_bound_ms:.5f} ({ddim_bound_by})")
    check(ddim_err <= DDIM_TOL, f"ddim: max_err {ddim_err} > {DDIM_TOL}")
    del x, eps, out, scratch

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
    firsts = {}
    for workflow in ("chain", "dag"):
        spec, wtimes = workflow_spec(workflow, pipe, times=times)
        # record the diffusion stage's output (pre-decode latents) per seed:
        # the frames saturate the decoder's tanh at these random weights
        for st in spec.stages:
            if st.name == "diffusion":
                st.fn = _tap(st.fn, workflow, served_latents, request_seeds)
        # admission control is not under test here: admit both at once
        ws = build_set(spec, counts={s: 1 for s in wtimes}, admit_rate=100.0,
                       cfg=PORT, name=workflow, elastic=False)
        reqs = [make_request(PORT, rng, i) for i in range(2)]
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
        check(fl == per_req_flash * len(reqs), f"{workflow}: flash launches {fl}")
        check(dd == per_req_ddim * len(reqs), f"{workflow}: ddim launches {dd}")
        shape = (1, PORT.num_frames, PORT.image_size, PORT.image_size, 3)
        for o in outs:
            check(o.shape == shape and np.isfinite(o).all(),
                  f"{workflow}: frames {o.shape} not finite of shape {shape}")
        firsts[workflow] = (reqs[0], outs[0])
    req, served = firsts["chain"]
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
    for workflow, (req, _) in firsts.items():
        seeds = [req["seed"]]
        temb = pipe.encode_text(pipe.tensor(req["tokens"]))
        z = pipe.vae_encode(pipe.tensor(req["image"]), seeds)
        lat = pipe.diffuse(pipe.image_tokens(z), temb, seeds).cpu().numpy()[0]
        lat_err = float(np.abs(served_latents[(workflow, req["seed"])] - lat).max())
        tol = SERVE_LATENT_RTOL * float(np.abs(lat).max())
        print(f"serve: {workflow} request 0 latents vs the pipeline's "
              f"max_err={lat_err:.3g} (tol {SERVE_LATENT_RTOL} x max|x| = {tol:.3g})")
        check(lat_err <= tol, f"{workflow}: served latents differ")

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
             at="dit_self", shapes=flash_rows),
        dict(name="ddim_step", route="cuda",
             source="src/repro_torch/kernels/ddim_step/csrc/ddim_step.cu",
             replaces="src/repro/kernels/ddim_step/kernel.py:33",
             launches=served_launches["ddim_step"], max_abs_err=ddim_err,
             ms=ddim_ms, plain_ms=ddim_plain_ms, bound_ms=ddim_bound_ms,
             bound_by=ddim_bound_by, library_ms=None, at="latent [1,18900,64]"),
    ]
    print(f"total {time.perf_counter() - t_start:.1f}s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


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


def _to(torch, tree, dev):
    if isinstance(tree, dict):
        return {k: _to(torch, v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(torch, v, dev) for v in tree]
    return tree.to(dev)


if __name__ == "__main__":
    sys.exit(main())

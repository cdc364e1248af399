"""Where a request's device time goes: one monolithic ``generate`` at a
profile's widths under ``torch.profiler``, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_request --profile port

Prints the per-stage wall times, then the device time by kernel (top rows
of ``key_averages``), the kernels' summed device time against the
request's wall time (the device's busy share; overlapping kernels would
count twice, and this eager path runs one stream), and the launch counts of
the port's own kernels.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.wan_i2v import PROFILES
from repro_torch.kernels import ddim_step, flash_attention
from repro_torch.launch.serve import make_request
from repro_torch.models.aigc import WanI2VPipeline
from repro_torch.models.aigc.pipeline import measure_stage_times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default="port", choices=sorted(PROFILES))
    ap.add_argument("--rows", type=int, default=12)
    args = ap.parse_args()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipe = WanI2VPipeline(cfg=PROFILES[args.profile], seed=0)
    cfg = pipe.cfg
    print(f"device: {torch.cuda.get_device_name(0)}")
    times = measure_stage_times(pipe, n_warm=1, n_iter=1)
    print("stage wall (s):", {k: round(v, 4) for k, v in times.items()})

    req = make_request(cfg, np.random.default_rng(0), 0)
    pipe.generate(req["tokens"], req["image"], seed=0)  # warm
    torch.cuda.synchronize()
    flash_attention.launches = ddim_step.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.generate(req["tokens"], req["image"], seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"request wall {wall * 1e3:.1f} ms; device busy {busy_us / 1e3:.1f} ms "
          f"({busy_us / 1e4 / wall:.1f} %); launches flash="
          f"{flash_attention.launches} ddim={ddim_step.launches}")
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  kernel")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:args.rows]:
        print(f"{e.self_device_time_total / 1e3:10.2f} "
              f"{100 * e.self_device_time_total / max(busy_us, 1):5.1f}% "
              f"{e.count:6d}  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

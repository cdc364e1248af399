#!/usr/bin/env python3
"""zamba2-1.2b's served prefill and training step with the port of the tree
at ROOT, on a machine with a CUDA card: one line each.

    python3 scripts/zamba2_parent_change.py ROOT [--prefills N] [--steps N]

``PREFILL``: prefills of one 256-token prompt (the served path's,
``ServingEngine.prefill`` at full width and depth in bfloat16), each timed
between device syncs after one warm-up, their median; then one more with
the SSD recurrence's calls timed between device syncs (ROOT's
``mamba2._ssd`` where it has one, else its step loop ``mamba2.ssd_scan``),
their sum and their share of that prefill.  ``STEP``: ROOT's launcher at
full width and depth (4 x 256 tokens of the bigram chain over 1,024 ids at
lr 1e-3, as the smoke's zamba2 run), each step's time after the first,
their median and the peak memory.  Step times spread between runs, so
compare two trees in one call, in turns: parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import gc
import pathlib
import statistics
import sys
import time


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--prefills", type=int, default=5)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    from repro_torch.launch import train as launcher
    from repro_torch.launch.serve import llm_config
    from repro_torch.models import mamba2
    from repro_torch.serving import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    engine = ServingEngine(llm_config("zamba2-1.2b", "port", ""), max_len=1024, seed=0)
    prompt = np.random.default_rng(1).integers(
        0, engine.cfg.vocab_size, (1, 256)).astype(np.int32)

    def prefill_s() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.prefill(prompt)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    prefill_s()
    walls = [prefill_s() for _ in range(args.prefills)]
    entry = "_ssd" if hasattr(mamba2, "_ssd") else "ssd_scan"
    inner, spent = getattr(mamba2, entry), []

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **k)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    setattr(mamba2, entry, timed)
    try:
        wall = prefill_s()
    finally:
        setattr(mamba2, entry, inner)
    print(f"PREFILL {root.name} 256 tokens ms {[round(1e3 * w, 1) for w in walls]} median "
          f"{1e3 * statistics.median(walls):.1f}; with mamba2.{entry} timed "
          f"{1e3 * wall:.1f} ms, of which {1e3 * sum(spent):.1f} ms in {len(spent)} calls "
          f"({100 * sum(spent) / wall:.1f} %)", flush=True)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    out = launcher.train(launcher.parser().parse_args(
        ["--arch", "zamba2-1.2b", "--preset", "full", "--steps", str(args.steps),
         "--batch", "4", "--seq", "256", "--log-every", str(args.steps), "--lr", "1e-3",
         "--data-vocab", "1024"]))
    steps, peak = out["step_s"][1:], out["peak_bytes"]
    print(f"STEP {root.name} zamba2-1.2b steps ms {[round(1e3 * s, 1) for s in steps]} "
          f"median {1e3 * statistics.median(steps):.1f} peak {peak / 2 ** 30:.2f} GiB",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

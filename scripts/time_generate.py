#!/usr/bin/env python3
"""Decode-step time of ``ServingEngine.generate`` for whisper-large-v3 and
qwen3-1.7b at full width in bfloat16 (B 4, a 4-token prompt, 64 new
tokens, five runs after a warm-up), with the port of the tree at ROOT, on a
machine with a CUDA card.

    python3 scripts/time_generate.py ROOT

Both models' decode steps are host-bound, so their times vary from run to
run and from call to call: compare two trees inside one call, in turns
(parent, change, change, parent), with the parent unpacked by ``git
archive`` into a git-ignored directory.  Prints ROOT and, per model, the
median ms a decode step and the five runs.
"""
from __future__ import annotations

import statistics
import sys
import time


def main(root: str) -> None:
    sys.path.insert(0, root + "/src")
    import numpy as np
    import torch

    from repro_torch.launch.serve import llm_config
    from repro_torch.serving import ServingEngine

    out = {}
    for arch in ("whisper-large-v3", "qwen3-1.7b"):
        cfg = llm_config(arch, "port")
        engine = ServingEngine(cfg, max_len=448, seed=0)
        prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, (4, 4)).astype(np.int32)
        engine.generate(prompts, steps=8)
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.generate(prompts, steps=64)   # syncs: tokens to the host
            runs.append((time.perf_counter() - t0) * 1e3 / 64)
        out[arch] = (round(statistics.median(runs), 3), [round(x, 2) for x in runs])
        del engine
        torch.cuda.empty_cache()
    print(root, out, flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit("usage: time_generate.py ROOT")
    main(sys.argv[1])

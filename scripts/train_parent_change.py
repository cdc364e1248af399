#!/usr/bin/env python3
"""A few training steps of one model through the launcher of the tree at
ROOT, on a machine with a CUDA card: each step's time after the first,
their median and the peak memory, on one line.

    python3 scripts/train_parent_change.py ROOT [--slice E] [LAUNCHER ARGS ...]

LAUNCHER ARGS go to ROOT's ``repro_torch.launch.train`` (default: qwen3-1.7b
at full width, 8 steps of 4 x 256 tokens of the bigram chain over 1,024
ids at lr 1e-3, as the smoke's training run).  ``--slice E`` sets AdamW's
slice (``training.optimizer.SLICE``) to 2^E elements where ROOT's optimizer
has one; a tree from before the slices updates whole leaves.  The step is
host-bound and its time spreads between runs, so compare two trees (or two
slice sizes) in one call, in turns: parent, change, change, parent.
"""
from __future__ import annotations

import pathlib
import statistics
import sys

DEFAULT = ["--arch", "qwen3-1.7b", "--preset", "full", "--steps", "8", "--batch", "4",
           "--seq", "256", "--log-every", "8", "--lr", "1e-3", "--data-vocab", "1024"]


def main(argv) -> int:
    root, rest = pathlib.Path(argv[0]).resolve(), argv[1:]
    exponent = None
    if rest[:1] == ["--slice"]:
        exponent, rest = int(rest[1]), rest[2:]
    sys.path.insert(0, str(root / "src"))
    from repro_torch.launch import train as launcher
    from repro_torch.training import optimizer

    if exponent is not None and hasattr(optimizer, "SLICE"):
        optimizer.SLICE = 1 << exponent
    args = launcher.parser().parse_args(rest or DEFAULT)
    out = launcher.train(args)
    steps, peak = out["step_s"][1:], out["peak_bytes"]
    print(f"STEP {root.name} slice {getattr(optimizer, 'SLICE', 'whole leaves')} {args.arch} "
          f"steps ms {[round(1e3 * s, 1) for s in steps]} median "
          f"{1e3 * statistics.median(steps):.1f} peak "
          + (f"{peak / 2 ** 30:.2f} GiB" if peak is not None else "(not on a card)"))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

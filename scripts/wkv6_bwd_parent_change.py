#!/usr/bin/env python3
"""The WKV6 backward at the smoke's shapes with the port of the tree at
ROOT, on a machine with a CUDA card: each case's time, saved to OUT.

    python3 scripts/wkv6_bwd_parent_change.py ROOT OUT
    python3 scripts/wkv6_bwd_parent_change.py --compare OUT1 OUT2 ...

The cases and their inputs are this tree's ``chip_smoke.py``'s
(``WKV_BWD_CASES``, ``wkv6_bwd_inputs`` from a generator seeded 27),
whichever ROOT's port runs them, and each is timed by the smoke's
``kernel_and_plain_ms`` with ROOT's ``wkv6_backward`` in both of its
slots (kernel, kernel, kernel, kernel in turns; the mean of the two
results): ``device_ms`` (inputs out of the L2) where a call takes under
``DEVICE_TIME_BELOW_MS``, else the median of single calls between events.

It calls only ``wkv6_backward``, which every tree since the rwkv6
training slice has, so that a parent unpacked by ``git archive`` into a
git-ignored directory runs it too.  Time two trees in one call, in turns
(parent, change, change, parent).  ``--compare`` prints, per case, each
run's ms and the first run's over each later one's.
"""
from __future__ import annotations

import importlib.util
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]


def _smoke():
    """This tree's chip_smoke.py, by its path: its cases and timing."""
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(root: str, out: str) -> None:
    cs = _smoke()
    sys.path.insert(0, root + "/src")
    import torch

    from repro_torch.kernels import wkv6_backward

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    res = {"root": root, "card": smi.stdout.strip(), "cases": {}}
    gen = torch.Generator(device=dev).manual_seed(27)
    for name, b, t, h, kk, dt, nonzero, model, reps in cs.WKV_BWD_CASES:
        xs = cs.wkv6_bwd_inputs(torch, dev, gen, b, t, h, kk, dt, nonzero, model)
        sets = cs.rotation(xs[:7]) if xs[7] is None else cs.rotation(xs)
        fns = [lambda c=c: wkv6_backward(*c) for c in sets]
        ms, ms2, call_ms, _ = cs.kernel_and_plain_ms(torch, fns, fns, reps)
        res["cases"][name] = {"ms": (ms + ms2) / 2, "call_ms": call_ms}
        del xs, sets, fns
    torch.save(res, out)
    print(f"{root} on {res['card']}: " + ", ".join(
        f"{n} {c['ms']:.4f}" for n, c in res["cases"].items()))


def compare(paths) -> int:
    import torch

    runs = [torch.load(p) for p in paths]
    print("runs: " + ", ".join(f"{r['root']} ({r['card']})" for r in runs))
    for name, first in runs[0]["cases"].items():
        ms = [r["cases"][name]["ms"] for r in runs]
        print(f"wkv6 backward {name}: ms " + " / ".join(f"{m:.4f}" for m in ms)
              + "; first over each: " + " / ".join(f"{ms[0] / m:.2f}x" for m in ms[1:]))
    return 0


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2:]))
    run(sys.argv[1], sys.argv[2])

#!/usr/bin/env python3
"""The bfloat16 flash forward at the served prefill shapes
(``chip_smoke.FLASH_BF16_CASES``) with the port of the tree at ROOT, on a
machine with a CUDA card: each case's output on fixed inputs, and its
device ms (``chip_smoke.device_ms``, inputs out of the L2), saved to OUT.

    python3 scripts/flash_fwd_parent_change.py ROOT OUT
    python3 scripts/flash_fwd_parent_change.py --compare OUT1 OUT2 ...

It calls only ``flash_attention`` under ``no_grad``, which every tree since
the bfloat16 forward kernel has, so that a parent unpacked by ``git
archive`` into a git-ignored directory runs it too.  Time two trees in one
call, in turns (parent, change, change, parent).  ``--compare`` prints, per
case, each run's ms and whether its output equals the first run's bit for
bit, and exits 1 if one does not.
"""
from __future__ import annotations

import sys


def run(root: str, out: str) -> None:
    sys.path.insert(0, root + "/src")
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import flash_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"root": root, "cases": {}}
    for name, (b, sq, sk, h, kv, d), causal, _ in cs.FLASH_BF16_CASES:
        q = torch.randn(b, sq, h, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(b, sk, kv, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(b, sk, kv, d, generator=gen, device=dev).bfloat16()
        with torch.no_grad():
            o = flash_attention(q, k, v, causal=causal)
            sets = cs.rotation((q, k, v))
            ms = cs.device_ms(torch, [lambda c=c: flash_attention(*c, causal=causal)
                                      for c in sets])
        res["cases"][name] = {"o": o.cpu(), "ms": ms}
        del q, k, v, o, sets
    torch.save(res, out)
    print(f"{root}: " + ", ".join(f"{n} {c['ms']:.4f}" for n, c in res["cases"].items()))


def compare(paths) -> int:
    import torch

    runs = [torch.load(p) for p in paths]
    print("runs: " + ", ".join(r["root"] for r in runs))
    bad = 0
    for name, first in runs[0]["cases"].items():
        same = [torch.equal(r["cases"][name]["o"], first["o"]) for r in runs]
        bad += not all(same)
        print(f"{name}: ms " + " / ".join(f"{r['cases'][name]['ms']:.4f}" for r in runs)
              + f"; outputs equal to the first run's: {same}")
    return 1 if bad else 0


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2:]))
    run(sys.argv[1], sys.argv[2])

#!/usr/bin/env python3
"""The flash forward at the smoke's shapes with the port of the tree at
ROOT, on a machine with a CUDA card: each case's output on fixed inputs (a
SHA-256 of its bytes) and its time, saved to OUT.

    python3 scripts/flash_fwd_parent_change.py ROOT OUT [--backward]
    python3 scripts/flash_fwd_parent_change.py --compare OUT1 OUT2 ...

The cases are this tree's ``chip_smoke.py``'s, whichever ROOT's port runs
them: the bfloat16 forward at the served prefill shapes
(``FLASH_BF16_CASES``) and the float32 forward at the Wan ``PORT`` profile's
and the other float32 shapes (``flash_f32_cases``).  Times are
``chip_smoke.device_ms`` (inputs out of the L2) where a call takes under
``DEVICE_TIME_BELOW_MS``, else the median of 3 single calls between
events.  Last, the backward at the smoke's training shapes
(``TRAIN_BWD_CASES``, bfloat16 and float32), timed the same way: from the
forward's log-sum-exp where ROOT's forward stores it, else without (a tree
whose float32 backward recomputed it; every tree with a bfloat16 backward
stores it).

It calls only ``flash_attention`` under ``no_grad``, and
``flash_attention_backward``, which every tree since the training slice
has, so that a parent unpacked by ``git archive`` into a git-ignored
directory runs it too.  Time two trees in one call, in turns (parent,
change, change, parent).  ``--compare`` prints, per case, each run's ms
and whether its forward output equals the first run's bit for bit, and
exits 1 if one does not (a change to a forward's arithmetic changes its
bits by design: read the cases then).  ``--backward`` times the backward
alone.
"""
from __future__ import annotations

import hashlib
import importlib.util
import pathlib
import statistics
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]


def _smoke():
    """This tree's chip_smoke.py, by its path: its cases and timing."""
    spec = importlib.util.spec_from_file_location("chip_smoke_cases", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ms(torch, cs, fns) -> float:
    if statistics.median(cs.cuda_times(torch, fns[0], 3)) < cs.DEVICE_TIME_BELOW_MS:
        return cs.device_ms(torch, fns)
    return statistics.median(cs.cuda_times(torch, fns[0], 3))


def run(root: str, out: str, forward: bool = True) -> None:
    cs = _smoke()
    sys.path.insert(0, root + "/src")
    import torch

    from repro_torch.configs.wan_i2v import PORT
    from repro_torch.kernels import flash_attention, flash_attention_backward

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"root": root, "cases": {}, "backward": {}}
    cases = [(n, shape, c, torch.bfloat16) for n, shape, c, _ in cs.FLASH_BF16_CASES]
    cases += [(f"f32_{n}", shape, c, torch.float32) for n, shape, c, _ in cs.flash_f32_cases(PORT)]
    cases = cases if forward else []
    for name, (b, sq, sk, h, kv, d), causal, dtype in cases:
        q = torch.randn(b, sq, h, d, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, sk, kv, d, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, sk, kv, d, generator=gen, device=dev).to(dtype)
        with torch.no_grad():
            o = flash_attention(q, k, v, causal=causal)
            digest = hashlib.sha256(o.contiguous().view(torch.uint8).cpu().numpy()).hexdigest()
            del o
            sets = cs.rotation((q, k, v))
            ms = _ms(torch, cs, [lambda c=c: flash_attention(*c, causal=causal)
                                 for c in sets])
        res["cases"][name] = {"o_sha256": digest, "ms": ms}
        del q, k, v, sets
    try:   # a forward that stores the float32 log-sum-exp
        from repro_torch.kernels.flash_attention import flash_attention_with_lse
        probe = torch.zeros(1, 64, 1, 32, device=dev)
        flash_attention_with_lse(probe, probe, probe)
        stores_lse = True
    except (ImportError, ValueError):
        stores_lse = False
    for name, (b, sq, sk, h, kv, d), causal, dt, _ in cs.TRAIN_BWD_CASES:
        dtype = getattr(torch, dt)
        q, do = (torch.randn(b, sq, h, d, generator=gen, device=dev).to(dtype) for _ in range(2))
        k, v = (torch.randn(b, sk, kv, d, generator=gen, device=dev).to(dtype) for _ in range(2))
        if stores_lse:
            o, lse = flash_attention_with_lse(q, k, v, causal=causal)
        else:
            with torch.no_grad():
                o, lse = flash_attention(q, k, v, causal=causal), None
        sets = cs.rotation((q, k, v, o, do))
        ms = _ms(torch, cs, [lambda c=c: flash_attention_backward(*c, causal=causal, lse=lse)
                             for c in sets])
        res["backward"][name] = {"ms": ms, "dtype": dt}
        del q, k, v, o, do, lse, sets
    torch.save(res, out)
    print(f"{root}: " + ", ".join(f"{n} {c['ms']:.4f}" for n, c in res["cases"].items())
          + "; backward " + ", ".join(f"{n} {c['ms']:.4f}" for n, c in res["backward"].items()))


def compare(paths) -> int:
    import torch

    runs = [torch.load(p) for p in paths]
    print("runs: " + ", ".join(r["root"] for r in runs))
    bad = 0
    for name, first in runs[0]["cases"].items():
        same = [r["cases"][name]["o_sha256"] == first["o_sha256"] for r in runs]
        bad += not all(same)
        print(f"{name}: ms " + " / ".join(f"{r['cases'][name]['ms']:.4f}" for r in runs)
              + f"; outputs equal to the first run's: {same}")
    for name in runs[0]["backward"]:
        print(f"backward {name} ({runs[0]['backward'][name].get('dtype', 'float32')}): ms "
              + " / ".join(f"{r['backward'][name]['ms']:.4f}" for r in runs))
    return 1 if bad else 0


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2:]))
    run(sys.argv[1], sys.argv[2], forward="--backward" not in sys.argv[3:])

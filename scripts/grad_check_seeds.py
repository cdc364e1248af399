#!/usr/bin/env python3
"""Every family's full-width gradient check of ``chip_smoke.py`` at other
seeds, on a machine with a CUDA card: how far each check's margin rests on
the smoke's one draw of weights and tokens.

    python3 scripts/grad_check_seeds.py [SEED ...] [--out PATH]

For each SEED (default 1 and 2; the smoke's own draw is seed 0) it runs, as
the smoke's training phase does and at its limits: qwen3-1.7b's check on
the init rule's weights, rwkv6-7b's five-way check, and every entry of
``FAMILY_GRAD_CHECKS`` (on the fan-in weights unless the family is in
``RULE_WEIGHTS_FAMILIES``, the dropless MoE families against their routing
yardstick), each with the weights drawn from generator SEED, the tokens
from the data's seed SEED and the frames or patches from generator
``INPUT_SEED`` + SEED (``family_grad_check``'s ``seed``).  A check past its
limit does not stop the run: it is recorded as a failure beside its
readings.  Per check it prints the worst leaf and its share, the median,
the loss's relative distance, the yardstick where there is one, and the
init-weights flash calls' largest share from float64; the JSON of all of
it goes to PATH (default ``build/grad_check_seeds.json``).  It exits
1 if any check failed.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parents[1]


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _summary(out: dict) -> dict:
    """The readings of one check's result that the seeds are compared by."""
    keys = ("worst_leaf", "worst_share", "median_share", "loss_rel", "limits",
            "yardstick_worst", "yardstick_median", "weights")
    row = {k: out[k] for k in keys if k in out}
    init = out.get("init_attention") or []
    if init:
        row["init_share"] = max(max(r["share"].values()) for r in init)
        row["init_score_max"] = max(r["score_max"] for r in init)
    return row


def _rwkv6_summary(out: dict) -> dict:
    """rwkv6's pairs: worst and median leaf of each, by dtype."""
    keys = ("worst_leaf", "worst_share", "median_share", "loss_rel", "held", "tol_worst",
            "tol_median")
    return {f"{dt} {pair}": {k: r[k] for k in keys if k in r}
            for dt, rows in out.items() for pair, r in rows.items() if isinstance(r, dict)}


def main(argv) -> int:
    out_path = HERE / "build" / "grad_check_seeds.json"
    if "--out" in argv:
        i = argv.index("--out")
        out_path = pathlib.Path(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    seeds = [int(a) for a in argv] or [1, 2]
    sys.path.insert(0, str(HERE / "src"))
    import torch

    if not torch.cuda.is_available():
        print("grad_check_seeds: no CUDA device", file=sys.stderr)
        return 2
    cs = _smoke()
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    _build.library()
    dev = torch.device("cuda")
    failures = []

    def record(ok: bool, msg: str) -> None:
        if not ok:
            failures.append(msg)
            print(f"grad_check_seeds: past its limit: {msg}", flush=True)
    cs.check = record          # every check of the smoke's functions records, not stops

    results = {}
    for seed in seeds:
        checks = [("qwen3", lambda s=seed: cs.family_grad_check(
            torch, dev, "train", "qwen3-1.7b", dict(num_layers=cs.GRAD_CHECK_LAYERS), seed=s)),
            ("rwkv6", lambda s=seed: cs.rwkv6_grad_check(torch, dev, s))]
        checks += [(label, lambda s=seed, a=arch, o=over, lb=label: cs.family_grad_check(
            torch, dev, lb, a, o, seed=s)) for label, (arch, over) in cs.FAMILY_GRAD_CHECKS.items()]
        for label, fn in checks:
            before = len(failures)
            t0 = time.perf_counter()
            print(f"=== seed {seed}: {label}", flush=True)
            out = fn()
            row = _rwkv6_summary(out) if label == "rwkv6" else _summary(out)
            row["failures"] = failures[before:]
            row["seconds"] = time.perf_counter() - t0
            results[f"seed {seed} {label}"] = row
            print(f"seed {seed} {label}: " + json.dumps(row, default=str), flush=True)
            del out
            gc.collect()
            torch.cuda.empty_cache()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(results, indent=1, default=str))
    print(f"grad_check_seeds: {len(results)} checks, {len(failures)} past their limits; "
          f"-> {out_path}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Training launcher: a few AdamW steps of a model on the bigram data, on
one device (the JAX package's ``src/repro/launch/train.py``, plus
``--device`` and ``--data-vocab``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --preset full --steps 8 --batch 4 --seq 256 --lr 1e-3 --data-vocab 1024
    PYTHONPATH=src python -m repro_torch.launch.train --preset smoke \
        --steps 30 --device cpu

It runs on ``cuda`` unless ``--device`` names another device, and raises
without a card.  Every ``--log-every`` steps (and at step 1) it prints the
cross entropy, the gradient norm, tokens/s and, on the card, the peak
memory; it exits 0 only if the last cross entropy is below the first.

``--data-vocab N`` draws the bigram chain's tokens from the first N ids;
the model keeps its whole vocabulary.  Over qwen3-1.7b's 151,936 ids a
batch of 1,024 tokens almost never repeats one, so a few steps learn
nothing of the chain and the cross entropy only wanders by the batch's
noise; over 1,024 ids it falls within a few steps.

A VLM's stub patch embeddings (over the first min(frontend_tokens, S)
positions) are drawn N(0, 1) from ``--seed``, where the JAX launcher feeds
zeros: at S <= frontend_tokens (256 for internvl2-1b) zeros make the whole
sequence zero, every RMSNorm's gradient there is rsqrt(eps) = 1000 times
its input's, and at 24 layers the bfloat16 gradient overflows to NaN in
the first step (with the plain attention too).  An audio model's stub
frames stay zero, as the JAX launcher's: their positional embedding keeps
the encoder's input nonzero.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.device import generator, resolve_device
from repro_torch.models import registry
from repro_torch.training import adamw_init, make_train_step
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.data import data_iterator
from repro_torch.training.train_step import init_params

PRESETS = {
    # ~100M-param dense config for the end-to-end CPU example
    "100m": dict(num_layers=12, d_model=512, num_heads=8, num_kv_heads=4,
                 head_dim=64, d_ff=2048, vocab_size=32_768, vocab_round=256),
    "smoke": dict(num_layers=2, d_model=128, num_heads=2, num_kv_heads=1,
                  head_dim=64, d_ff=256, vocab_size=1_024, vocab_round=64),
}


def build_config(arch: str, preset: str):
    cfg = get_config(arch)
    if preset == "full":
        return cfg
    if preset in PRESETS:
        over = dict(PRESETS[preset])
        if cfg.num_experts:  # keep the family's structure at reduced width
            over.update(num_experts=min(cfg.num_experts, 8),
                        top_k=min(cfg.top_k, 2), d_ff=512)
        if cfg.family == "ssm":
            over.update(num_heads=over["d_model"] // 64, head_dim=64)
        return dataclasses.replace(cfg, dtype="float32", **over)
    return dataclasses.replace(cfg.reduced(), dtype="float32")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--preset", default="100m", choices=["100m", "smoke", "reduced", "full"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-vocab", type=int, default=0,
                    help="draw the bigram data's tokens from the first N ids "
                         "(default: the model's whole vocabulary)")
    ap.add_argument("--device", default=None,
                    help="torch device; cuda unless given (cpu runs the plain versions)")
    return ap


def train(args: argparse.Namespace) -> Dict[str, Any]:
    """Runs the steps; -> {"ce": [per step], "grad_norm": [...], "step_s":
    [...], "tokens_per_s", "peak_bytes" (None off the card), "cfg"}."""
    dev = resolve_device(args.device)
    cfg = build_config(args.arch, args.preset)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params={registry.count_params(cfg) / 1e6:.1f}M B={args.batch} S={args.seq} "
          f"dtype={cfg.dtype} device={dev}", flush=True)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(cfg, generator(args.seed, dev), dev)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, lr=args.lr, dropless=cfg.num_experts > 0)
    if not 0 <= args.data_vocab <= cfg.vocab_size:
        raise ValueError(f"--data-vocab {args.data_vocab} outside the model's "
                         f"{cfg.vocab_size} ids")
    data = data_iterator(args.data_vocab or cfg.vocab_size, args.batch, args.seq,
                         seed=args.seed)
    dtype = getattr(torch, cfg.dtype)
    patches = generator(args.seed, dev)

    def adapt(batch):
        b = {k: torch.as_tensor(v, dtype=torch.long, device=dev) for k, v in batch.items()}
        if cfg.family == "vlm":
            b["patch_embeds"] = torch.randn(
                (args.batch, min(cfg.frontend_tokens, args.seq), cfg.d_model),
                generator=patches, device=dev).to(dtype)
        if cfg.family == "audio":
            b["frames"] = torch.zeros((args.batch, cfg.frontend_tokens, cfg.d_model),
                                      dtype=dtype, device=dev)
        return b

    out: Dict[str, Any] = {"ce": [], "grad_norm": [], "step_s": [], "cfg": cfg}
    t0 = time.perf_counter()
    for step in range(1, args.steps + 1):
        ts = time.perf_counter()
        params, opt, m = step_fn(params, opt, adapt(next(data)))
        ce, gnorm = float(m["ce"]), float(m["grad_norm"])   # both wait for the card
        out["step_s"].append(time.perf_counter() - ts)
        out["ce"].append(ce)
        out["grad_norm"].append(gnorm)
        if step % args.log_every == 0 or step == 1:
            tok_s = args.batch * args.seq * step / (time.perf_counter() - t0)
            mem = (f" peak={torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f}GiB"
                   if on_card else "")
            print(f"step {step:5d} ce={ce:7.4f} grad={gnorm:7.3f} "
                  f"tok/s={tok_s:8.0f}{mem}", flush=True)
    wall = time.perf_counter() - t0
    out["tokens_per_s"] = args.batch * args.seq * args.steps / wall
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if on_card else None
    first, last = out["ce"][0], out["ce"][-1]
    print(f"done: ce {first:.4f} -> {last:.4f} "
          f"({(first - last) / first * 100:.1f}% drop) in {wall:.0f}s", flush=True)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params, opt, args.steps)
        print(f"checkpoint -> {args.checkpoint}")
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    out = train(parser().parse_args(argv))
    return 0 if out["ce"][-1] < out["ce"][0] else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""Sharded against unsharded: a model run with DTensor weights, cache and
inputs over a mesh, each output held against the same model run unsharded
on the same weights in the same process.

    python -m repro_torch.launch.shard_check
        # four gloo processes on the CPU (a 2x2 data x model mesh), the
        # reduced float32 models (qwen3 prefill, decode over a cache sharded
        # along its sequence and one train step; deepseek-moe through the
        # sharded moe_ffn, also at its own capacity; rwkv6 through WKV6
        # under local_map; zamba2 through the SSD scan under local_map);
        # rank 0 prints one JSON line

Every rank makes the same whole weights from the seed and keeps its shards
(``Partitioner.distribute_tree``).  The functions here are also what
``chip_smoke.py`` runs on the card's 1x1 mesh, where the sharded outputs
must equal the unsharded ones bit for bit.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs import SHAPES, ModelConfig, get_config
from repro_torch.convert import to_port_layout
from repro_torch.launch.dryrun_lib import rules_for
from repro_torch.models import registry
from repro_torch.models.param import init_tree, tree_leaves, use_partitioner
from repro_torch.sharding import Partitioner

#: float32 parity, element by element: |a - b| <= RTOL |b| + ATOL
RTOL = ATOL = 2e-5
#: the CPU check's mesh: data x model
MESH = (2, 2)
#: seconds the CPU check's four processes may take
TIMEOUT_S = 600.0


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def compare(a: torch.Tensor, b: torch.Tensor) -> Dict[str, Any]:
    """a (sharded run, gathered) against b (unsharded): max |a - b|, its
    share of the float32 limit, and whether the bits are equal."""
    a, b = _full(a).detach().float(), b.detach().float()
    d = (a - b).abs()
    return {"max_abs": float(d.max()) if d.numel() else 0.0,
            "limit_use": float((d / (ATOL + RTOL * b.abs())).max()) if d.numel() else 0.0,
            "equal": bool(torch.equal(_full(a), b))}


def compare_by_max(a: torch.Tensor, b: torch.Tensor) -> Dict[str, Any]:
    """a against b by b's largest element, |a - b| <= ATOL + RTOL max |b|:
    for a result that sums many terms in another order when sharded (a
    gradient, the d_ff partials), whose elements near zero keep the
    rounding of its largest."""
    a, b = _full(a).detach().float(), b.detach().float()
    d = float((a - b).abs().max())
    return {"max_abs": d, "limit_use": d / (ATOL + RTOL * float(b.abs().max()))}


def _weights(cfg: ModelConfig, seed: int, device):
    specs = registry.abstract_params(cfg)
    return specs, init_tree(specs, torch.Generator(device=device).manual_seed(seed), device)


def check_inference(cfg: ModelConfig, mesh, *, batch: int, prompt: int, max_len: int,
                    steps: int, seed: int = 0, device="cpu", rules: Optional[dict] = None,
                    on_sharded: Optional[Callable[[], None]] = None) -> Dict[str, Any]:
    """Prefill of ``batch`` prompts of ``prompt`` tokens into a cache of
    ``max_len`` positions, then ``steps`` decode steps at positions prompt,
    prompt + 1, ..., each fed the unsharded run's greedy tokens: the logits of
    each, sharded against unsharded.  Rules: ``rules_for`` a decode shape
    (the cache's sequence over ``model``) unless given.  ``on_sharded`` is
    called just before the sharded run (``chip_smoke.py`` zeroes the kernels'
    launch counters there)."""
    rules = rules_for(cfg, SHAPES["decode_32k"]) if rules is None else rules
    part = Partitioner(mesh, rules)
    specs, tree = _weights(cfg, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen, device=device)
    out: Dict[str, Any] = {}
    with torch.no_grad():
        params = to_port_layout(tree)
        logits, cache = registry.prefill(params, tokens, cfg, max_len=max_len)
        feed, ref = [], [logits]
        for i in range(steps):
            feed.append(logits.argmax(-1))
            logits = registry.decode_step(params, cache, feed[-1], prompt + i, cfg)
            ref.append(logits)
        del params, cache
        if on_sharded is not None:
            on_sharded()
        with use_partitioner(part):
            dparams = to_port_layout(part.distribute_tree(tree, specs))
            del tree
            lg, dcache = registry.prefill(dparams, part.distribute(tokens, ("batch", "seq")),
                                          cfg, max_len=max_len)
            out["prefill"] = compare(lg, ref[0])
            for i in range(steps):
                lg = registry.decode_step(dparams, dcache, part.distribute(feed[i], ("batch",)),
                                          prompt + i, cfg)
                out[f"decode_{prompt + i}"] = compare(lg, ref[i + 1])
    return out


def check_train_step(cfg: ModelConfig, mesh, *, batch: int, seq: int, seed: int = 0,
                     device="cpu", rules: Optional[dict] = None,
                     on_sharded: Optional[Callable[[], None]] = None) -> Dict[str, Any]:
    """One ``make_train_step`` step from the same weights and batch: the
    loss, the gradient norm and every parameter after the step, sharded
    against unsharded (rules: ``rules_for`` the train shape unless given).
    Each run's weights are made afresh from the seed, so that only one
    model's optimizer state is alive at a time."""
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import make_train_step, trainable

    rules = rules_for(cfg, SHAPES["train_4k"]) if rules is None else rules
    part = Partitioner(mesh, rules)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    data = {k: torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=device)
            for k in ("tokens", "labels")}
    step = make_train_step(cfg)
    specs, tree = _weights(cfg, seed, device)
    tree = trainable(tree)
    p1, _, m1 = step(tree, adamw_init(tree), data)
    after = [p.detach() for p in tree_leaves(p1)]
    del p1, tree
    specs, tree = _weights(cfg, seed, device)
    if on_sharded is not None:
        on_sharded()
    with use_partitioner(part):
        dtree = trainable(part.distribute_tree(tree, specs))
        del tree
        p2, _, m2 = step(dtree, adamw_init(dtree), {k: part.distribute(v, ("batch", "seq"))
                                                      for k, v in data.items()})
    out = {"loss": compare(m2["loss"], m1["loss"]),
           "grad_norm": compare(m2["grad_norm"], m1["grad_norm"])}
    leaves = [compare(b, a) for a, b in zip(after, tree_leaves(p2))]
    out["params"] = {"max_abs": max(x["max_abs"] for x in leaves),
                     "limit_use": max(x["limit_use"] for x in leaves),
                     "equal": all(x["equal"] for x in leaves), "leaves": len(leaves)}
    return out


def check_gradients(cfg: ModelConfig, mesh, *, batch: int, seq: int, seed: int = 0,
                    device="cpu", rules: Optional[dict] = None) -> Dict[str, Any]:
    """The loss and every parameter's gradient of ``registry.loss_fn``,
    sharded against unsharded: the loss element by element, each gradient
    leaf by its largest element (|a - b| <= ATOL + RTOL max |b|; a leaf
    sums many terms in another order when sharded).  Where AdamW's first
    step is close to a sign function, a gradient element near zero moves a
    parameter by up to twice the learning rate either way, so a model with
    such elements is held here, before the step."""
    from repro_torch.training.train_step import trainable

    rules = rules_for(cfg, SHAPES["train_4k"]) if rules is None else rules
    part = Partitioner(mesh, rules)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    data = {k: torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=device)
            for k in ("tokens", "labels")}

    def grads(tree, batch_):
        loss, _ = registry.loss_fn(to_port_layout(tree), batch_, cfg)
        return loss, torch.autograd.grad(loss, tree_leaves(tree), allow_unused=True)

    specs, tree = _weights(cfg, seed, device)
    l1, g1 = grads(trainable(tree), data)
    specs, tree = _weights(cfg, seed, device)
    with use_partitioner(part):
        l2, g2 = grads(trainable(part.distribute_tree(tree, specs)),
                       {k: part.distribute(v, ("batch", "seq")) for k, v in data.items()})
    uses = [compare_by_max(a, b)["limit_use"] for a, b in zip(g2, g1)
            if a is not None and b is not None]
    return {"loss": compare(l2, l1), "gradients": {"limit_use": max(uses), "leaves": len(uses)}}


def check_moe_capacity(cfg: ModelConfig, mesh, *, batch: int, seq: int, seed: int = 0,
                       device="cpu") -> Dict[str, Any]:
    """The sharded ``moe_ffn`` of the first MoE layer at the config's own
    capacity, where experts overflow.  Sharded, each data shard counts
    capacity over its own tokens, as the JAX package's ``shard_map`` does;
    so the output is held against the unsharded dispatch run on each data
    shard's batch rows in turn (routing is per token), by its largest
    element (``compare_by_max``: the d_ff partials sum in another order, and
    the reduced weights give outputs in the thousands; an assignment kept on
    one side and dropped on the other moves a token's row by as much), and
    the load-balancing loss against the unsharded one over the whole batch.
    ``dropped`` counts the assignments the shards drop, which must be some
    for the check to see the capacity."""
    from repro_torch.models import moe

    part = Partitioner(mesh, rules_for(cfg, SHAPES["train_4k"]))
    specs, tree = _weights(cfg, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn(batch, seq, cfg.d_model, generator=gen, device=device)
    x = x.to(getattr(torch, cfg.dtype))
    tok = part.placements(x.shape, ("batch", None, None))
    n = 1
    for dim, p in enumerate(tok):
        n *= mesh.size(dim) if p.is_shard() else 1
    lp = to_port_layout(tree)["layers"][0]
    with torch.no_grad():
        top_w, top_i, aux = moe._router(x, lp, cfg)
        rows = batch // n
        ref = torch.cat([moe._dispatch_compute(x[i:i + rows], top_w[i:i + rows],
                                               top_i[i:i + rows], lp, cfg)
                         for i in range(0, batch, rows)])
        cap = moe._capacity(rows * seq, cfg)
        dropped = sum(int((torch.bincount(top_i[i:i + rows].reshape(-1),
                                          minlength=cfg.num_experts) - cap).clamp(min=0).sum())
                      for i in range(0, batch, rows))
        with use_partitioner(part):
            dlp = to_port_layout(part.distribute_tree(tree, specs))["layers"][0]
            out, daux = moe.moe_ffn(part.distribute(x, ("batch", None, None)), dlp, cfg)
    return {"out": compare_by_max(out, ref), "aux": compare(daux, aux), "dropped": dropped,
            "data_shards": n}


def reduced(arch: str, **over) -> ModelConfig:
    """The CPU parity tests' float32 reduced config."""
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32", **over)


def cpu_checks(mesh) -> Dict[str, Any]:
    """The reduced float32 models of the CPU parity test: qwen3 (prefill of
    14 tokens into a cache of 32, decode at 14-17, so that while the index is
    below 16 the second half of the sequence holds no valid position; one
    train step, also with one kv head, which does not divide over ``model``:
    each shard reads the slice its query heads map to), deepseek-moe (the
    sharded ``moe_ffn``, with a capacity that drops nothing: sharded, each
    data shard's capacity counts its own tokens, so a drop would differ by
    design; prefill, decode, and the loss and gradients, ``check_gradients``;
    then ``moe_ffn`` alone at the config's own capacity against the
    unsharded dispatch on each data shard's tokens, ``check_moe_capacity``)
    rwkv6 (the same, through WKV6) and zamba2 (the same, through the SSD
    scan and its in- and out-projections on local shards)."""
    out = {}
    qwen = reduced("qwen3-1.7b")
    out["qwen3"] = check_inference(qwen, mesh, batch=2, prompt=14, max_len=32, steps=4)
    out["qwen3_train"] = check_train_step(qwen, mesh, batch=2, seq=16)
    out["qwen3_kv1_train"] = check_train_step(dataclasses.replace(qwen, num_kv_heads=1),
                                              mesh, batch=2, seq=16)
    moe = reduced("deepseek-moe-16b")
    moe = dataclasses.replace(moe, capacity_factor=float(moe.num_experts))
    out["deepseek_moe"] = check_inference(moe, mesh, batch=2, prompt=12, max_len=16, steps=2)
    out["deepseek_moe_grad"] = check_gradients(moe, mesh, batch=2, seq=16)
    out["deepseek_moe_capacity"] = check_moe_capacity(reduced("deepseek-moe-16b"), mesh,
                                                      batch=4, seq=32)
    rwkv = reduced("rwkv6-7b")
    out["rwkv6"] = check_inference(rwkv, mesh, batch=2, prompt=12, max_len=16, steps=2)
    out["rwkv6_grad"] = check_gradients(rwkv, mesh, batch=2, seq=16)
    zamba = reduced("zamba2-1.2b")
    out["zamba2"] = check_inference(zamba, mesh, batch=2, prompt=12, max_len=16, steps=2)
    out["zamba2_grad"] = check_gradients(zamba, mesh, batch=2, seq=16)
    return out


def _worker(args) -> int:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    world = MESH[0] * MESH[1]
    store = dist.FileStore(args.store, world)
    dist.init_process_group("gloo", store=store, rank=args.rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
        out = cpu_checks(mesh)
        if args.rank == 0:
            print(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="sharded against unsharded, on the CPU")
    ap.add_argument("--store", default=None, help="FileStore path (a fresh file)")
    ap.add_argument("--rank", type=int, default=None, help="(internal) this worker's rank")
    args = ap.parse_args(argv)
    if args.rank is not None:
        return _worker(args)
    import tempfile

    store = args.store or os.path.join(tempfile.mkdtemp(), "store")
    world = MESH[0] * MESH[1]
    cmd = [sys.executable, "-m", "repro_torch.launch.shard_check", "--store", store]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    rc = 0
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        if p.returncode:
            rc = p.returncode
            print(f"rank {r} exited {p.returncode}:\n{se[-4000:]}", file=sys.stderr)
        elif r == 0:
            print(so.strip().splitlines()[-1])
    return rc


if __name__ == "__main__":
    sys.exit(main())

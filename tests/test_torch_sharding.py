"""Sharding in the port (``repro_torch.sharding``, the models under a
partitioner, the kernels under ``local_map``) against the JAX package's
partition rules and against the port's own unsharded path.

- Partition specs: for every arch and supported shape, at 16x16 and
  2x16x16, under ``rules_for``'s rules, ``partition_spec`` gives every leaf
  of the parameters, the cache, the inputs and the AdamW state the mesh
  axes the JAX package's ``partition_spec`` gives it.  The JAX function is
  handed a duck-typed mesh (``axis_names`` and a numpy ``devices`` array of
  the mesh's shape); nothing in ``src/repro/`` changes.
- The kernels' custom ops pass ``torch.library.opcheck``; the plain decode
  with a log-sum-exp gives zeros and -inf to a row without a valid position.
- One device: on a 1x1 gloo mesh, the reduced models' sharded prefill,
  decode and train step equal the unsharded ones bit for bit.
- A real 2x2 mesh: four gloo processes (``python -m
  repro_torch.launch.shard_check``, a ``FileStore`` under ``tmp_path``) run
  the reduced float32 qwen3 (prefill, decode over a cache sharded along its
  sequence, one train step, also with one kv head), deepseek-moe (the
  sharded ``moe_ffn``) and rwkv6, each held against the unsharded port at
  float32 2e-5 element by element (gradients by each leaf's largest
  element).  qwen3's decode at 14 and 15 leaves the sequence's second shard
  without a valid position.  deepseek-moe's ``moe_ffn`` also runs at the
  config's own capacity, where each data shard drops its own overflow.
- ``use_partitioner(None)`` turns sharding off inside a partitioner's
  block, and ``zeros`` makes DTensors only for a caller that runs on them.

A process group made here is destroyed by its fixture: xdist's
``--dist loadfile`` runs other files in the same worker process.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, supported_shapes
from repro_torch.launch.dryrun_lib import rules_for
from repro_torch.models import registry
from repro_torch.models.param import tree_leaves
from repro_torch.sharding import Partitioner, partition_spec
from repro_torch.training.optimizer import adamw_abstract

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CASES = [(a, s) for a in ARCH_IDS for s in supported_shapes(get_config(a))]


def _ref_mesh(shape, names):
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape, dtype=object))


def _port_mesh(shape, names):
    return types.SimpleNamespace(mesh_dim_names=names, shape=shape)


def _trees(reg, cfg, shape, adamw):
    trees = [reg.abstract_params(cfg), reg.input_specs(cfg, shape),
             adamw(reg.abstract_params(cfg))]
    if shape.mode != "train":
        trees.append(reg.abstract_cache(cfg, shape.global_batch, shape.seq_len))
    return trees


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape_id", CASES)
def test_partition_specs_equal_the_reference(arch, shape_id, mesh):
    import jax

    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro.launch.dryrun_lib import rules_for as ref_rules_for
    from repro.models import registry as ref_registry
    from repro.models.param import is_spec
    from repro.sharding.partition import partition_spec as ref_partition_spec
    from repro.training.optimizer import adamw_abstract as ref_adamw

    cfg, ref_cfg = get_config(arch), ref_config(arch)
    shape, ref_shape = SHAPES[shape_id], REF_SHAPES[shape_id]
    rules, ref_rules = rules_for(cfg, shape), ref_rules_for(ref_cfg, ref_shape)
    dims, names = MESHES[mesh]
    n = 0
    for tree, ref_tree in zip(_trees(registry, cfg, shape, adamw_abstract),
                              _trees(ref_registry, ref_cfg, ref_shape, ref_adamw)):
        leaves, ref_leaves = tree_leaves(tree), jax.tree.leaves(ref_tree, is_leaf=is_spec)
        assert len(leaves) == len(ref_leaves)
        for s, r in zip(leaves, ref_leaves):
            assert (s.shape, s.logical) == (tuple(r.shape), tuple(r.logical))
            want = tuple(ref_partition_spec(r.shape, r.logical, _ref_mesh(dims, names),
                                            ref_rules))
            assert partition_spec(s.shape, s.logical, _port_mesh(dims, names), rules) == want
            n += 1
    assert n > 10


def test_placements_shard_in_mesh_order_and_keep_size_one_dims_whole():
    from torch.distributed.tensor import Replicate, Shard

    part = Partitioner(_port_mesh((2, 16, 16), ("pod", "data", "model")))
    assert part.placements((64, 4096, 2048), ("batch", "seq", "act_embed")) == (
        Shard(0), Shard(0), Replicate())
    assert part.placements((2048, 16, 128), ("embed", "heads", None)) == (
        Replicate(), Shard(0), Shard(1))
    # kv_heads 2 do not divide over 16: replicated, as the JAX rules say
    assert part.spec((2048, 2, 128), ("embed", "kv_heads", None)) == ("data",)
    one = Partitioner(_port_mesh((1, 1), ("data", "model")))
    assert one.spec((4, 1, 32), ("embed", "kv_heads", None)) == ("data", "model")
    assert one.placements((4, 1, 32), ("embed", "kv_heads", None)) == (Shard(0), Replicate())


# ------------------------------------------------------------- custom ops
def _op_cases():
    g = torch.Generator().manual_seed(0)

    def r(*s):
        return torch.randn(s, generator=g)

    q, k, v = r(1, 8, 2, 32), r(1, 8, 1, 32), r(1, 8, 1, 32)
    dq, kc, vc = r(2, 2, 3, 32), r(2, 2, 16, 32), r(2, 2, 16, 32)
    kq = torch.randint(-127, 128, (2, 2, 16, 32), dtype=torch.int8, generator=g)
    ks = torch.rand(2, 2, 16, generator=g) + 0.01
    cur = torch.tensor([5, -1], dtype=torch.int32)
    w = torch.rand(1, 5, 2, 32, generator=g)
    st = torch.zeros(1, 2, 32, 32)
    rk = [r(1, 5, 2, 32) for _ in range(3)]
    ops = torch.ops.repro
    return {
        "flash_attention": (ops.flash_attention.default, (q, k, v, True, 0.2)),
        "flash_attention_lse": (ops.flash_attention_lse.default, (q, k, v, False, 0.2)),
        "flash_attention_backward": (ops.flash_attention_backward.default,
                                     (q, k, v, q.clone(), r(1, 8, 2, 32), True, 0.2, None)),
        "decode_attention": (ops.decode_attention.default, (dq, kc, vc, cur, 2)),
        "decode_attention_lse": (ops.decode_attention_lse.default, (dq, kc, vc, cur, 2)),
        "decode_attention_int8": (ops.decode_attention_int8.default,
                                  (dq, kq, kq.clone(), ks, ks.clone(), cur, 2)),
        "decode_attention_int8_lse": (ops.decode_attention_int8_lse.default,
                                      (dq, kq, kq.clone(), ks, ks.clone(), cur, 2)),
        "wkv6": (ops.wkv6.default, (*rk, w, r(2, 32), st)),
        "wkv6_backward": (ops.wkv6_backward.default,
                          (*rk, w, r(2, 32), st, r(1, 5, 2, 32), None)),
    }


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_custom_op_passes_opcheck(name):
    import repro_torch.kernels  # noqa: F401  (registers the ops)

    op, args = _op_cases()[name]
    torch.library.opcheck(op, args)


def test_decode_lse_plain_version():
    """Each row's log-sum-exp of its valid scaled scores, and zeros with -inf
    for a row with no valid position; the output otherwise the plain decode's."""
    from repro_torch.kernels.decode_attention import decode_lse_ref, decode_ref

    g = torch.Generator().manual_seed(1)
    q, kc, vc = (torch.randn(s, generator=g) for s in ((2, 2, 3, 32), (2, 2, 16, 32),
                                                       (2, 2, 16, 32)))
    cur = torch.tensor([6, -1])
    out, lse = decode_lse_ref(q, kc, vc, cur)
    assert torch.equal(out[0], decode_ref(q, kc, vc, cur)[0])
    assert torch.equal(out[1], torch.zeros_like(out[1])) and torch.isneginf(lse[1]).all()
    sc = torch.einsum("ngd,ntd->ngt", q[0] * 32 ** -0.5, kc[0, :, :7])
    torch.testing.assert_close(lse[0], torch.logsumexp(sc, dim=-1), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ one device
@pytest.fixture
def one_device_mesh(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b", "rwkv6-7b", "zamba2-1.2b"])
def test_sharded_path_on_one_device_equals_the_unsharded_bit_for_bit(arch, one_device_mesh):
    """On one device every local op is the unsharded op: prefill, decode and
    one train step give the same bits (as ``chip_smoke.py`` holds them on the
    card at full width)."""
    from repro_torch.launch.shard_check import check_inference, check_train_step, reduced

    torch.set_num_threads(2)
    cfg = reduced(arch)
    got = check_inference(cfg, one_device_mesh, batch=2, prompt=6, max_len=12, steps=2)
    got["train"] = check_train_step(cfg, one_device_mesh, batch=2, seq=8)
    for name, res in got.items():
        rows = res.values() if name == "train" else [res]
        assert all(r["equal"] for r in rows), (name, res)


def test_use_partitioner_none_clears_it_and_zeros_follow_the_caller(one_device_mesh):
    """``use_partitioner(None)`` inside a partitioner's block turns sharding
    off until its own block ends; ``zeros`` gives DTensors only where the
    tensor it is handed is one, so an unsharded caller gets plain tensors
    while a partitioner is in use."""
    from repro_torch.launch.dryrun_lib import rules_for
    from repro_torch.models.param import (
        ParamSpec, current_partitioner, is_dtensor, use_partitioner, zeros)

    cfg = get_config("qwen3-1.7b")
    part = Partitioner(one_device_mesh, rules_for(cfg, SHAPES["train_4k"]))
    spec = {"k": ParamSpec((2, 4), ("batch", None), "float32", "zeros")}
    like = part.distribute(torch.ones(2, 4), ("batch", None))
    assert current_partitioner() is None
    with use_partitioner(part):
        assert current_partitioner() is part
        assert is_dtensor(zeros(spec, "cpu", like)["k"])
        assert not is_dtensor(zeros(spec, "cpu", torch.ones(2))["k"])
        assert not is_dtensor(zeros(spec, "cpu")["k"])
        with use_partitioner(None):
            assert current_partitioner() is None
            assert not is_dtensor(zeros(spec, "cpu", like)["k"])
        assert current_partitioner() is part
    assert current_partitioner() is None


# --------------------------------------------------------------- 2x2 mesh
@pytest.fixture(scope="module")
def two_by_two(tmp_path_factory):
    store = tmp_path_factory.mktemp("shard_check") / "store"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.shard_check",
                           "--store", str(store)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _held(res):
    assert res["limit_use"] <= 1.0, res


def test_qwen3_prefill_and_decode_on_a_2x2_mesh(two_by_two):
    got = two_by_two["qwen3"]
    # decode 14 and 15: the cache's second half (16..31) holds no valid position
    assert {"prefill", "decode_14", "decode_15", "decode_16", "decode_17"} <= set(got)
    for res in got.values():
        _held(res)


@pytest.mark.parametrize("name", ["qwen3_train", "qwen3_kv1_train"])
def test_qwen3_train_step_on_a_2x2_mesh(two_by_two, name):
    """One AdamW step; with one kv head, which does not divide over
    ``model``, each shard reads a slice of the kv heads and their gradient
    sums the slices'."""
    got = two_by_two[name]
    for key in ("loss", "grad_norm", "params"):
        _held(got[key])
    assert got["params"]["leaves"] == 13


def test_deepseek_moe_sharded_moe_ffn_on_a_2x2_mesh(two_by_two):
    for res in two_by_two["deepseek_moe"].values():
        _held(res)


def test_deepseek_moe_capacity_drops_per_data_shard_on_a_2x2_mesh(two_by_two):
    """At the config's own capacity some assignments overflow; each data
    shard drops its own, as the unsharded dispatch on that shard's tokens
    does (``shard_check.check_moe_capacity``)."""
    got = two_by_two["deepseek_moe_capacity"]
    assert got["data_shards"] == 2 and got["dropped"] > 0, got
    _held(got["out"])
    _held(got["aux"])


def test_rwkv6_wkv6_under_local_map_on_a_2x2_mesh(two_by_two):
    for res in two_by_two["rwkv6"].values():
        _held(res)


def test_zamba2_ssd_under_local_map_on_a_2x2_mesh(two_by_two):
    """Prefill (the chunked SSD scan on each rank's heads) and decode."""
    got = two_by_two["zamba2"]
    assert {"prefill", "decode_12", "decode_13"} <= set(got)
    for res in got.values():
        _held(res)


@pytest.mark.parametrize("name", ["deepseek_moe_grad", "rwkv6_grad", "zamba2_grad"])
def test_sharded_gradients_on_a_2x2_mesh(two_by_two, name):
    """The loss and every gradient leaf (``shard_check.check_gradients``):
    the routing's gradient sums the d_ff shards' (the sharded ``moe_ffn``),
    the WKV6 bonus's the batch shards', B's and C's of the SSD scan the
    head shards'."""
    got = two_by_two[name]
    _held(got["loss"])
    _held(got["gradients"])

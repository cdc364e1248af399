"""The port's dry-run (``repro_torch.launch.{mesh,dryrun_lib,dryrun,
hlo_analysis}``) against the JAX package's.

- Exact parity: ``rules_for``, ``model_flops`` and ``analytic_min_bytes``
  equal the JAX package's for every arch and supported shape.
- The counter (``hlo_analysis.analyze``): a loop of 10 and loops of 4 x 5
  count the matrix products the JAX package's two trip-count tests expect;
  a 1x1 mesh shows no collective bytes; on a fake 2x2 mesh a Megatron MLP
  shows one all-reduce of its local [B/2, S, D] output and per-chip (local)
  flops and peak within 10 % of the analytic figures, where the global
  figures are four times larger.
- Flops against the JAX package: on a 1x1 gloo mesh the reduced float32
  decode steps of qwen3, rwkv6 and deepseek-moe count within 2 % of
  ``repro.launch.hlo_analysis.analyze`` of the same step jitted without a
  mesh, at a batch of 16: a decode step's skinny products run on blocks of
  16 rows in the port (``layers.row_blocks_matmul``, so that a row's bits do
  not depend on its batch), which at a batch of 2 are real extra work.
- One production case through the CLI, in a subprocess: it exits 0 and
  writes its figures.

A process group made here is destroyed by its fixture: xdist's
``--dist loadfile`` runs other files in the same worker process.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, supported_shapes
from repro_torch.launch import dryrun_lib
from repro_torch.launch.hlo_analysis import analyze

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(a, s) for a in ARCH_IDS for s in supported_shapes(get_config(a))]


@pytest.mark.parametrize("arch,shape_id", CASES)
def test_rules_flops_and_min_bytes_equal_the_reference(arch, shape_id):
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro.launch import dryrun_lib as ref

    cfg, shape = get_config(arch), SHAPES[shape_id]
    ref_cfg, ref_shape = ref_config(arch), REF_SHAPES[shape_id]
    assert dryrun_lib.rules_for(cfg, shape) == ref.rules_for(ref_cfg, ref_shape)
    assert dryrun_lib.model_flops(cfg, shape) == ref.model_flops(ref_cfg, ref_shape)
    for n in (256, 512):
        assert (dryrun_lib.analytic_min_bytes(cfg, shape, n)
                == ref.analytic_min_bytes(ref_cfg, ref_shape, n))
    assert dryrun_lib.TRAIN_MICROBATCHES == ref.TRAIN_MICROBATCHES


# ---------------------------------------------------------------- counter
def test_counter_counts_each_pass_of_a_loop():
    def looped(w, x):
        for _ in range(10):
            x = torch.tanh(x @ w)
        return x.sum()

    r = analyze(looped, torch.randn(128, 128), torch.randn(8, 128))
    assert r["flops"] == pytest.approx(2 * 8 * 128 * 128 * 10, rel=0.01)


def test_counter_multiplies_nested_loops():
    def nested(w, x):
        for _ in range(4):
            for _ in range(5):
                x = torch.tanh(x @ w)
        return x.sum()

    r = analyze(nested, torch.randn(64, 64), torch.randn(4, 64))
    assert r["flops"] == pytest.approx(2 * 4 * 64 * 64 * 20, rel=0.01)


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


@pytest.fixture
def fake_2x2():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import fake_process_group

    fake_process_group(4)
    try:
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _decode_case(arch, batch, mesh):
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    shape = dataclasses.replace(SHAPES["decode_32k"], seq_len=64, global_batch=batch)
    with FakeTensorMode():
        return dryrun_lib.build_case(cfg, shape, mesh)


def test_one_by_one_mesh_shows_no_collectives(one_device_mesh):
    r = analyze(*_flat(_decode_case("qwen3-1.7b", 2, one_device_mesh)))
    assert r["collective_bytes"] == 0.0 and r["collective_count_by_kind"] == {}
    assert r["flops"] > 0


def _flat(case):
    fn, args = case
    return (fn, *args)


def test_fake_2x2_megatron_mlp_counts_local_shards(fake_2x2):
    """Column- then row-parallel MLP over ``model``, batch over ``data``, in
    bfloat16: per chip 2 B/2 S D F/2 flops twice, one all-reduce of the
    local [B/2, S, D] output, and a peak of the local weights, input, the
    two [B/2, S, F/2] intermediates and the output."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = fake_2x2
    b, s, d, f = 8, 512, 1024, 4096
    bf = torch.bfloat16
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(b, s, d, dtype=bf), mesh, [Shard(0), Replicate()])
        w1 = distribute_tensor(torch.empty(d, f, dtype=bf), mesh, [Replicate(), Shard(1)])
        w2 = distribute_tensor(torch.empty(f, d, dtype=bf), mesh, [Replicate(), Shard(0)])

    def mlp(x, w1, w2):
        return (torch.relu(x @ w1) @ w2).redistribute(mesh, [Shard(0), Replicate()])

    r = analyze(mlp, x, w1, w2)
    local_flops = 2 * 2 * (b // 2) * s * d * (f // 2)
    assert r["flops"] == pytest.approx(local_flops, rel=0.10)
    assert r["collective_count_by_kind"] == {"all-reduce": 1.0}
    assert r["collective_bytes_by_kind"]["all-reduce"] == (b // 2) * s * d * 2
    inner = (b // 2) * s * (f // 2) * 2
    peak = (b // 2) * s * d * 2 + 2 * d * (f // 2) * 2 + 2 * inner
    assert r["peak_bytes"] == pytest.approx(peak, rel=0.10)
    assert r["peak_bytes"] < 0.5 * 4 * peak     # not the global figures


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "rwkv6-7b", "deepseek-moe-16b"])
def test_decode_flops_match_the_reference(arch, one_device_mesh):
    import jax

    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro.launch import hlo_analysis as ref_analysis
    from repro.models import registry as ref_registry
    from repro.models.param import abstract_tree

    batch = 16
    mine = analyze(*_flat(_decode_case(arch, batch, one_device_mesh)))
    cfg = dataclasses.replace(ref_config(arch).reduced(), dtype="float32")
    shape = dataclasses.replace(REF_SHAPES["decode_32k"], seq_len=64, global_batch=batch)
    args = (abstract_tree(ref_registry.abstract_params(cfg)),
            abstract_tree(ref_registry.abstract_cache(cfg, batch, 64)),
            abstract_tree(ref_registry.input_specs(cfg, shape)))
    txt = jax.jit(lambda p, c, b: ref_registry.decode_step(p, c, b, cfg)).lower(
        *args).compile().as_text()
    ref = ref_analysis.analyze(txt)
    assert mine["flops"] == pytest.approx(ref["flops"], rel=0.02)


# -------------------------------------------------------------------- CLI
def test_dryrun_cli_traces_a_production_case(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                           "qwen3-1.7b", "--shape", "decode_32k", "--out", str(tmp_path)],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    stats = json.loads((tmp_path / "qwen3-1.7b__decode_32k__16x16.json").read_text())
    assert stats["n_chips"] == 256 and stats["mesh"] == "16x16"
    assert stats["flops_per_chip"] > 0 and stats["bytes_per_chip"] > 0
    assert stats["collective_bytes_per_chip"] > 0
    assert stats["memory"]["fits_hbm"] and stats["dominant"] in ("compute", "memory",
                                                                 "collective")


# ---------------------------------------------------- a fake 2x2x2 mesh
#: Reduced train steps that once held DTensor's redistribution search on a
#: (pod, data, model) mesh for minutes an op (a strided split, from a view
#: that flattened the batch split over two mesh axes with a sequence or a
#: head split, makes DTensor search every order of the three axes): rwkv6's
#: and zamba2's products on a sequence-parallel residual, gemma3's windowed
#: attention.  Each now runs on local shards; (arch, config overrides, seq,
#: global batch).
THREE_D_CASES = [("rwkv6-7b", dict(num_layers=1), 64, 8),
                 ("zamba2-1.2b", dict(num_layers=2), 64, 8),
                 ("gemma3-27b", dict(num_layers=6, sliding_window=16), 128, 64)]
#: seconds a case may take (it traces in ~15-30 s; each held op took 40-50 s)
THREE_D_TIMEOUT_S = 240

_TRACE_2X2X2 = """
import dataclasses, json, sys
from repro_torch.launch.mesh import fake_process_group
fake_process_group(8)
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun_lib
from repro_torch.launch.hlo_analysis import analyze
arch, over, seq, batch = json.loads(sys.argv[1])
mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
cfg = dataclasses.replace(get_config(arch).reduced(), **over)
shape = dataclasses.replace(SHAPES["train_4k"], seq_len=seq, global_batch=batch)
with FakeTensorMode():
    fn, args = dryrun_lib.build_case(cfg, shape, mesh)
r = analyze(fn, *args)
print(json.dumps({"flops": r["flops"], "collective_bytes": r["collective_bytes"]}))
"""


@pytest.mark.parametrize("arch,over,seq,batch", THREE_D_CASES)
def test_train_step_traces_on_a_fake_2x2x2_mesh(arch, over, seq, batch):
    """The reduced train step of ``build_case`` (loss, backward, AdamW)
    traced on a fake (pod, data, model) mesh of 2x2x2 in a subprocess,
    within ``THREE_D_TIMEOUT_S``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", _TRACE_2X2X2,
                           json.dumps([arch, over, seq, batch])], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=THREE_D_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["flops"] > 0 and got["collective_bytes"] > 0

"""The port's copy of the host layer (``core/``, ``cluster/`` and
``analysis/``: the runtime lock checks, the ring checker and the static
concurrency passes) against the JAX package's, and the port's locks under
the concurrency checks that ``tests/conftest.py`` applies to the JAX package
only.

- Text: each copied file equals the reference's once ``repro_torch`` reads
  ``repro``.  The reference's host-layer tests (ring buffer, cluster,
  control plane, fault tolerance, DAG workflows, transport) cover the port's
  copy only as long as this holds.
- Static passes: the port's own copy of lock order, guarded fields,
  blocking under a lock and jit purity over ``src/repro_torch`` finds
  nothing.
- Runtime: with the port's lock instrumentation on, one SMALL Wan chain and
  one reduced float32 qwen3 ``llm_disagg`` set served on the CPU observe no
  lock-order cycle, and the port's locks (``ContinuousDecoder._lock`` among
  them) are the ones observed.
"""
from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.analysis import run_all

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_PKG = ROOT / "src" / "repro_torch"
REF_PKG = ROOT / "src" / "repro"
COPIED = sorted(p.relative_to(PORT_PKG) for d in ("core", "cluster", "analysis")
                for p in (PORT_PKG / d).glob("*.py"))

torch.set_num_threads(2)


def test_the_copied_file_list_is_the_reference_host_layer():
    """Every module of the reference's core/, cluster/ and analysis/ has its
    copy, and nothing else is there."""
    ref = sorted(p.relative_to(REF_PKG) for d in ("core", "cluster", "analysis")
                 for p in (REF_PKG / d).glob("*.py"))
    assert COPIED == ref
    assert len(COPIED) == 28


@pytest.mark.parametrize("rel", COPIED, ids=str)
def test_host_layer_copy_equals_the_reference_as_text(rel):
    port = (PORT_PKG / rel).read_text()
    assert port.replace("repro_torch", "repro") == (REF_PKG / rel).read_text()


def test_static_passes_find_nothing_in_the_port():
    violations = run_all([PORT_PKG])
    assert violations == [], "\n".join(map(str, violations))


def test_port_ring_checker_sees_a_clean_protocol():
    """The checker that ``core/ring_buffer.py`` names is the port's own."""
    from repro_torch.analysis.ring_checker import RingProtocolChecker
    from repro_torch.core import DoubleRingBuffer, RdmaFabric, RingProducer

    rb = DoubleRingBuffer(RdmaFabric(), "port", n_slots=4, buf_size=256)
    rb.checker = RingProtocolChecker("port")
    p = RingProducer(rb, 1)
    for i in range(12):
        assert p.append(bytes([i]) * 60)
        assert rb.poll() == bytes([i]) * 60
    assert not p.append(b"x" * 300)          # larger than the ring: aborts
    rb.checker.assert_clean()
    assert rb.checker.open_ops() == 0


@pytest.fixture
def instrumented():
    from repro_torch.analysis import runtime

    was = runtime.instrumentation_enabled()
    runtime.default_graph().clear()
    runtime.instrument_locks(True)
    try:
        yield runtime
    finally:
        runtime.instrument_locks(was)


def _serve_wan_chain():
    from repro_torch.configs.wan_i2v import SMALL
    from repro_torch.launch.serve import STAGES, build_set, make_request, serve, workflow_spec
    from repro_torch.models.aigc import WanI2VPipeline

    pipe = WanI2VPipeline(cfg=SMALL, seed=0, device="cpu")
    spec, times = workflow_spec("chain", pipe, times={s: 0.01 for s in STAGES})
    ws = build_set(spec, counts={s: 1 for s in times}, admit_rate=100.0,
                   cfg=SMALL, elastic=False)
    rng = np.random.default_rng(7)
    outs, lost, _ = serve(ws, [make_request(SMALL, rng, i) for i in range(2)],
                          timeout_s=120)
    assert lost == 0 and len(outs) == 2
    assert ws.transport_stats().dropped == 0


def _serve_qwen3_disagg():
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import check_served
    from repro_torch.serving import APP_LLM_DISAGG, ServingEngine, build_llm_disagg_set

    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(), dtype="float32")
    engine = ServingEngine(cfg, max_len=32, seed=0, device="cpu")
    ws, dec = build_llm_disagg_set(engine, name="locks", max_slots=2, segment_len=3)
    rng = np.random.default_rng(3)
    reqs = [{"prompt": rng.integers(0, cfg.vocab_size, (1, 4 + i)).astype(np.int32),
             "steps": 5, "temperature": 0.7 * (i % 2), "seed": 50 + i}
            for i in range(3)]
    with ws:
        p = ws.proxies[0]
        uids = [p.submit(APP_LLM_DISAGG, r) for r in reqs]
        res = [p.wait_result(u, timeout_s=60) for u in uids]
        assert ws.transport_stats().dropped == 0
    check_served(engine, reqs, res)
    assert dec.stats["completed"] == 3


def test_port_serving_runs_observe_no_lock_cycle(instrumented):
    runtime = instrumented
    _serve_wan_chain()
    _serve_qwen3_disagg()
    assert runtime.default_graph().find_cycles() == []
    names = set(runtime.lock_stats_snapshot())
    for name in ("ContinuousDecoder._lock", "Channel._lock", "Router._lock",
                 "MemoryRegion.atomic_lock", "NodeManager._lock"):
        assert name in names, sorted(names)

"""The port's Wan I2V pipeline served through its own Workflow Set (chain and
DAG) on the CPU at the SMALL profile: every request answered, nothing
dropped, served frames equal to the port's monolithic ``generate`` per
request, and microbatched frames equal to per-request frames within
tolerance.  Also the inbox-ring sizing that keeps full-width payloads from
being dropped.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.cluster import StageSpec, WorkflowSpec
from repro_torch.configs.wan_i2v import PORT, SMALL
from repro_torch.core import DoubleRingBuffer, RdmaFabric, RingProducer, WorkflowMessage
from repro_torch.launch.serve import (
    DEFAULT_RING_BYTES,
    STAGES,
    build_set,
    largest_message_bytes,
    make_request,
    ring_bytes_for,
    serve,
    workflow_spec,
)
from repro_torch.models.aigc import WanI2VPipeline
from repro_torch.models.aigc.pipeline import (
    build_stage_fns,
    measure_stage_times,
    request_seeds,
)

#: Small shapes gain nothing from many intra-op threads; the suite's other
#: workers (some timing-sensitive) share the machine's cores.
torch.set_num_threads(2)

TIMES = {s: 0.01 for s in STAGES}
#: Stacking requests changes the matmul shapes, and so where the CPU's
#: blocked kernels round: per-request frames of a batch agree to BATCH_TOL,
#: latents to BATCH_LATENT_RTOL of the largest latent.  At random weights the
#: decoder's tanh saturates (the JAX init rule), so frames alone would hide
#: small differences: the serving tests also hold the diffusion stage's
#: output latents against the pipeline's.
BATCH_TOL = dict(atol=1e-5, rtol=1e-5)
BATCH_LATENT_RTOL = 1e-5


@pytest.fixture(scope="module")
def pipe():
    return WanI2VPipeline(cfg=SMALL, seed=0, device="cpu")


def requests(n):
    rng = np.random.default_rng(7)
    return [make_request(SMALL, rng, i) for i in range(n)]


def one_per_stage(workflow, pipe, **kw):
    """-> (set, latents served by the diffusion stage, keyed by seed)."""
    spec, times = workflow_spec(workflow, pipe, times=TIMES)
    served = {}
    for st in spec.stages:
        if st.name == "diffusion":
            st.fn = _tap(st.fn, served)
    ws = build_set(spec, counts={s: 1 for s in times}, admit_rate=100.0,
                   cfg=pipe.cfg, elastic=False, **kw)
    return ws, served


def _tap(fn, served):
    def tapped(p):
        out = fn(p)
        lat = out["latents"]
        for s, row in zip(request_seeds(p["seed"], lat.shape[0]), lat):
            served[s] = row
        return out
    return tapped


def pipeline_latents(pipe, req):
    seeds = [req["seed"]]
    temb = pipe.encode_text(pipe.tensor(req["tokens"]))
    z = pipe.vae_encode(pipe.tensor(req["image"]), seeds)
    return pipe.diffuse(pipe.image_tokens(z), temb, seeds).numpy()[0]


def test_stage_fns_chain_equals_generate(pipe):
    fns = build_stage_fns(pipe)
    req = requests(1)[0]
    p = dict(req)
    for s in STAGES:
        p = fns[s](p)
    np.testing.assert_array_equal(
        p, pipe.generate(req["tokens"], req["image"], seed=req["seed"]))


@pytest.mark.parametrize("workflow", ["chain", "dag"])
def test_served_frames_equal_generate(pipe, workflow):
    ws, served = one_per_stage(workflow, pipe)
    reqs = requests(3)
    outs, lost, _ = serve(ws, reqs, timeout_s=120)
    assert lost == 0 and len(outs) == 3
    assert ws.transport_stats().dropped == 0
    for out, r in zip(outs, reqs):
        gold = pipe.generate(r["tokens"], r["image"], seed=r["seed"])
        assert out.shape == (1, SMALL.num_frames, SMALL.image_size,
                             SMALL.image_size, 3)
        np.testing.assert_array_equal(out, gold)
        np.testing.assert_array_equal(served[r["seed"]], pipeline_latents(pipe, r))
    if workflow == "dag":
        assert ws.joins.stats.completed == 3 and ws.joins.pending_joins() == 0


@pytest.mark.parametrize("workflow", ["chain", "dag"])
def test_batched_equals_per_request(pipe, workflow):
    ws, served = one_per_stage(workflow, pipe, max_batch=4, max_wait_s=0.05)
    reqs = requests(4)
    outs, lost, _ = serve(ws, reqs, batched=True, timeout_s=120)
    assert lost == 0 and ws.transport_stats().dropped == 0
    for out, r in zip(outs, reqs):
        gold = pipe.generate(r["tokens"], r["image"], seed=r["seed"])
        np.testing.assert_allclose(out, gold, **BATCH_TOL)
        lat = pipeline_latents(pipe, r)
        err = np.abs(served[r["seed"]] - lat).max()
        assert err <= BATCH_LATENT_RTOL * np.abs(lat).max(), err


def test_batch_rows_do_not_depend_on_neighbours(pipe):
    """Randomness is drawn per request seed: row i of a stacked call is row
    i of its own call."""
    reqs = requests(2)
    tokens = np.concatenate([r["tokens"] for r in reqs])
    image = np.concatenate([r["image"] for r in reqs])
    both = pipe.generate(tokens, image, seed=np.array([5, 9]))
    alone = pipe.generate(reqs[1]["tokens"], reqs[1]["image"], seed=9)
    np.testing.assert_allclose(both[1:], alone, **BATCH_TOL)


def test_measure_stage_times_covers_every_stage(pipe):
    times = measure_stage_times(pipe, n_warm=0, n_iter=1)
    assert set(times) == set(STAGES) and all(v > 0 for v in times.values())


def test_port_payloads_outgrow_the_default_ring():
    """At PORT's widths the diffusion stage's inbox message (text_emb
    [1,512,4096] + z_tokens [1,18900,64], float32) is ~13.2 MB, more than
    the 4 MiB default ring: ``ring_bytes_for`` sizes the rings from the
    shapes."""
    big = largest_message_bytes(PORT)
    assert 13.1e6 < big < 13.4e6 and big > DEFAULT_RING_BYTES
    assert ring_bytes_for(PORT) >= 2 * big
    assert ring_bytes_for(PORT, max_batch=2) >= 4 * big
    assert ring_bytes_for(SMALL) == DEFAULT_RING_BYTES

    payload = {"text_emb": np.zeros((1, PORT.text_len, PORT.text_d_model), np.float32),
               "z_tokens": np.zeros((1, PORT.video_tokens, 64), np.float32),
               "seed": 0}
    parts = WorkflowMessage.new(1, payload).pack_parts()
    assert sum(len(memoryview(p).cast("B")) for p in parts) < big
    small_rb = DoubleRingBuffer(RdmaFabric(), "default", n_slots=4,
                                buf_size=DEFAULT_RING_BYTES)
    assert not RingProducer(small_rb, 1).append(parts)
    sized_rb = DoubleRingBuffer(RdmaFabric(), "sized", n_slots=4,
                                buf_size=ring_bytes_for(PORT))
    assert RingProducer(sized_rb, 1).append(parts)
    assert RingProducer(sized_rb, 2).append(parts)


def test_build_set_sizes_every_inbox():
    spec = WorkflowSpec(1, "noop", [StageSpec(s, fn=lambda p: p, exec_time_s=0.01)
                                    for s in STAGES])
    ws = build_set(spec, counts={s: 1 for s in STAGES}, admit_rate=1.0,
                   cfg=PORT, elastic=False)
    assert {i.inbox.buf_size for i in ws.instances.values()} == {ring_bytes_for(PORT)}

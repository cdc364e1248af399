"""The ``a2v`` workflow (audio to video) of the port's launcher, held against
the JAX package's at the SMALL profile on the CPU.

a2v is the Wan DAG behind two toy front stages, ``asr`` and ``llm`` (numpy
transforms standing in for Whisper and a prompt-rewriting LLM): asr ->
(llm -> text_encode) ∥ image_encode -> diffusion -> vae_decode.  The toy
stages must give the JAX package's tokens bit for bit; the Wan stages
behind them must give its latents.  Noise is drawn per request seed by each
framework's own generator, so the JAX side is fed the port's draws.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.wan_i2v import SMALL as JAX_SMALL
from repro.launch import serve as jserve
from repro.models.aigc import WanI2VPipeline as JaxWanI2VPipeline
from repro.models.aigc import dit as jdit
from repro.models.aigc import text_encoder as jtext
from repro.models.aigc import vae as jvae
from repro_torch.configs.wan_i2v import PORT, SMALL
from repro_torch.convert import params_from_numpy
from repro_torch.launch.serve import (
    A2V_DEPS,
    build_a2v_stage_fns,
    build_set,
    largest_message_bytes,
    make_request,
    serve,
    workflow_spec,
)
from repro_torch.models.aigc import WanI2VPipeline
from repro_torch.models.aigc.pipeline import STREAM_DDIM, STREAM_VAE

#: Small shapes gain nothing from many intra-op threads; the suite's other
#: workers (some timing-sensitive) share the machine's cores.
torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-5)
#: tests/test_torch_wan.py's latent tolerance: the first DDIM step scales
#: the latents to |x| ~ 570, and the absolute part follows that scale
LATENT_TOL = dict(atol=5e-4, rtol=2e-5)
TIMES = {s: 0.01 for s in A2V_DEPS}


def numpy_params(spec, rng, name=""):
    """tests/test_torch_wan.py's rule: normal with std 1/sqrt(fan_in) over
    the contracted axes, 0.006 for the "small" leaves, 0.1 for the norm
    scales (zeros in the spec)."""
    if isinstance(spec, dict):
        return {k: numpy_params(spec[k], rng, k) for k in sorted(spec)}
    shape = spec.shape[1:] if spec.logical[0] == "layers" else spec.shape
    if name.endswith("wo") or len(shape) == 4:
        fan_in = int(np.prod(shape[:-1]))
    else:
        fan_in = shape[0]
    std = {"small": 0.006, "zeros": 0.1}.get(spec.init, 1 / np.sqrt(fan_in))
    return (rng.standard_normal(spec.shape) * std).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(0)
    return {name: numpy_params(mod.abstract_params(JAX_SMALL), rng)
            for name, mod in (("text", jtext), ("vae", jvae), ("dit", jdit))}


@pytest.fixture(scope="module")
def pipe(weights):
    return WanI2VPipeline(cfg=SMALL, device="cpu", params={
        k: params_from_numpy(v, device="cpu") for k, v in weights.items()})


@pytest.fixture(scope="module")
def jax_fns():
    """The JAX package's a2v stage fns; only its toy stages are called."""
    return jserve.build_a2v_stage_fns(JaxWanI2VPipeline(cfg=JAX_SMALL))


def requests(n, seed=3):
    rng = np.random.default_rng(seed)
    return [make_request(SMALL, rng, i, "a2v") for i in range(n)]


def test_a2v_request_and_topology_match_jax():
    """An a2v request carries audio [1, 2 text_len] and no tokens, from the
    same draws as the JAX package's; the DAG's edges are its edges."""
    assert A2V_DEPS == jserve.A2V_DEPS
    ours = requests(2)
    rng = np.random.default_rng(3)
    ref = [jserve.make_request("a2v", JAX_SMALL, rng, i) for i in range(2)]
    for a, b in zip(ours, ref):
        assert set(a) == set(b) == {"audio", "image", "seed"}
        assert a["audio"].shape == (1, 2 * SMALL.text_len)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_toy_asr_and_llm_stages_bit_equal_to_jax(pipe, jax_fns):
    fns = build_a2v_stage_fns(pipe)
    for req in requests(3) + [{"audio": np.linspace(-40, 40, 2 * SMALL.text_len,
                                                    dtype=np.float32)[None],
                               "image": np.zeros((1, 1)), "seed": 9}]:
        asr, jasr = fns["asr"](req), jax_fns["asr"](req)
        llm, jllm = fns["llm"](asr), jax_fns["llm"](jasr)
        for ours, ref in ((asr, jasr), (llm, jllm)):
            assert ours["tokens"].dtype == np.int32
            np.testing.assert_array_equal(ours["tokens"], ref["tokens"])
            assert ours["seed"] == ref["seed"] and ours["image"] is req["image"]
        assert llm["tokens"].max() < SMALL.text_vocab


def _jax_latents(weights, pipe, tokens, image, seed):
    """The JAX package's Wan functions on the port's noise for ``seed``."""
    mu, logvar = jvae.moments(weights["vae"], jnp.asarray(image), JAX_SMALL)
    g_vae = pipe.generators([seed], STREAM_VAE)[0]
    vae_noise = torch.randn(mu.shape[1:], generator=g_vae).numpy()[None]
    z = mu + jnp.exp(0.5 * logvar) * jnp.asarray(vae_noise)
    zt = jdit.patchify(jnp.repeat(z[:, None], SMALL.num_frames, axis=1), JAX_SMALL)
    g_ddim = pipe.generators([seed], STREAM_DDIM)[0]
    ddim_noise = torch.randn(zt.shape[1:], generator=g_ddim).numpy()[None]
    temb = jtext.encode_text(weights["text"], jnp.asarray(tokens), JAX_SMALL)
    lat = jdit.ddim_sample(weights["dit"], zt, temb, JAX_SMALL, None,
                           noise=jnp.asarray(ddim_noise))
    return np.asarray(temb), np.asarray(lat)


def test_stage_by_stage_latents_match_jax(weights, pipe, jax_fns):
    """The port's a2v stages one after the other (asr, llm, text_encode;
    asr, image_encode; the join's union into diffusion): the text embedding
    and the latents match the JAX package's functions on the tokens its own
    toy stages give."""
    fns = build_a2v_stage_fns(pipe)
    for req in requests(2, seed=4):
        asr = fns["asr"](req)
        text = fns["text_encode"](fns["llm"](asr))
        image = fns["image_encode"](asr)
        lat = fns["diffusion"]({**text, **image})["latents"]
        tokens = jax_fns["llm"](jax_fns["asr"](req))["tokens"]
        temb, ref = _jax_latents(weights, pipe, tokens, req["image"], req["seed"])
        np.testing.assert_allclose(text["text_emb"], temb, **TOL)
        np.testing.assert_allclose(lat, ref, **LATENT_TOL)
        frames = fns["vae_decode"]({"latents": lat})
        assert frames.shape == (1, SMALL.num_frames, SMALL.image_size,
                                SMALL.image_size, 3) and np.isfinite(frames).all()


def test_a2v_served_through_the_workflow_set(pipe, jax_fns):
    """Two requests through the port's Workflow Set, one instance per
    stage: nothing dropped, both joins assembled, none pending, and each
    video equal to the pipeline's ``generate`` for the tokens the toy
    stages make of its audio."""
    spec, times = workflow_spec("a2v", pipe, times={
        "text_encode": 0.01, "vae_encode": 0.01, "diffusion": 0.01,
        "vae_decode": 0.01})
    assert times == TIMES and set(spec.stage_names()) == set(A2V_DEPS)
    ws = build_set(spec, counts={s: 1 for s in times}, admit_rate=100.0,
                   cfg=SMALL, name="a2v", elastic=False)
    reqs = requests(2, seed=5)
    outs, lost, _ = serve(ws, reqs, timeout_s=120)
    assert lost == 0 and len(outs) == 2
    assert ws.transport_stats().dropped == 0 and ws.dead_uids() == set()
    assert ws.joins.stats.completed == 2 and ws.joins.pending_joins() == 0
    for stage in ("asr", "llm", "text_encode", "image_encode"):
        assert ws.instances[f"a2v.{stage}_0"].stats.processed == 2
    for out, r in zip(outs, reqs):
        tokens = jax_fns["llm"](jax_fns["asr"](r))["tokens"]
        np.testing.assert_array_equal(
            out, pipe.generate(tokens, r["image"], seed=r["seed"]))


def test_set_with_spare_instances_serves_a2v(pipe):
    """``spares`` adds idle-pool instances with no stage; the elastic
    control loop may pull them onto a hot stage.  The set serves with
    them."""
    spec, times = workflow_spec("a2v", pipe, times={
        "text_encode": 0.01, "vae_encode": 0.01, "diffusion": 0.01,
        "vae_decode": 0.01})
    ws = build_set(spec, counts={s: 1 for s in times}, admit_rate=100.0,
                   cfg=SMALL, name="spares", spares=2)
    assert {"spares.spare_0", "spares.spare_1"} <= set(ws.instances)
    outs, lost, _ = serve(ws, requests(2, seed=6), timeout_s=120)
    assert lost == 0 and ws.transport_stats().dropped == 0
    assert ws.joins.stats.completed == 2 and ws.joins.pending_joins() == 0


def test_a2v_payloads_fit_the_sized_rings():
    """The client's a2v message (audio [1, 2 text_len] and the image) is
    counted by ``largest_message_bytes``, which sizes every inbox."""
    for cfg in (SMALL, PORT):
        audio_image = 2 * cfg.text_len * 4 + cfg.image_size ** 2 * 3 * 4
        assert largest_message_bytes(cfg) > audio_image


def test_launcher_serves_a2v_on_the_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve as launcher

    monkeypatch.setattr("sys.argv", [
        "serve", "--workflow", "a2v", "--profile", "small", "--device", "cpu",
        "--requests", "2", "--no-elastic", "--profile-latency"])
    assert launcher.main() == 0
    out = capsys.readouterr().out
    assert "joins: 2 assembled" in out and "pending=0" in out
    assert "0 dropped" in out and "per-stage latency" in out

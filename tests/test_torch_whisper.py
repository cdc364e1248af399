"""The port's encoder-decoder (whisper-large-v3, the audio family) held
against the JAX package on the CPU, on the reduced float32 config (2
encoder and 2 decoder layers, d_model 256, 4 heads of 32, 16 stub frames):
the sinusoid, the encoder over random frames, prefill and decode logits and
caches (the cross K/V read at index F - 1 and never written),
``make_decode_cache``, greedy tokens, and the engine's ``generate`` against
its token-at-a-time ``generate_reference``.  Also the parameter count at
full width and the refusals: slot serving (``init_slots``, and so the
``llm`` workflow of the launcher) and an int8 cache.

Weights, frames and prompts are made with numpy from a seed and fed to both
frameworks; the port gets the weights through ``params_from_numpy``.  The
JAX side runs as its own tests run it on the CPU: attention through its
plain reference branches.  Tolerances: float32 2e-5 (docs/kernels.md);
greedy tokens identical.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import encdec as jed
from repro.models import registry as jregistry
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import ARCH_IDS, get_config, port_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.models import encdec, registry, transformer
from repro_torch.serving import ServingEngine

#: Small shapes gain nothing from many intra-op threads; the suite's other
#: workers (some timing-sensitive) share the machine's cores.
torch.set_num_threads(2)

ARCH = "whisper-large-v3"
TOL = dict(atol=2e-5, rtol=2e-5)
MAX_LEN = 32
DROPPED = {"use_pallas", "decode_unroll", "attn_causal_skip"}


def configs():
    """(JAX config, port config): the reduced config in float32."""
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), dtype="float32"),
            dataclasses.replace(get_config(ARCH).reduced(), dtype="float32"))


def numpy_params(spec, rng, name=""):
    """Normal with std 1/sqrt(fan_in) over the contracted axes (not the
    layer axis), so that activations stay O(1) and 2e-5 measures float32
    rounding; the embedding 1/sqrt(d_model); 0.1 for the norm scales (zeros
    in the spec)."""
    if isinstance(spec, dict):
        return {k: numpy_params(spec[k], rng, k) for k in sorted(spec)}
    shape = spec.shape[1:] if spec.logical[0] == "layers" else spec.shape
    fan_in = int(np.prod(shape[:-1])) if name.endswith("wo") else shape[0]
    if name == "embedding":
        fan_in = shape[1]
    std = 0.1 if spec.init == "zeros" else 1 / np.sqrt(fan_in)
    return (rng.standard_normal(spec.shape) * std).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    return numpy_params(jed.abstract_params(configs()[0]), np.random.default_rng(31))


@pytest.fixture(scope="module")
def port_weights(weights):
    return params_from_numpy(weights, device="cpu")


def t(x):
    return torch.from_numpy(np.array(x))


def frames(b, seed=2):
    _, cfg = configs()
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)


def prompts(n, p, seed=1):
    _, cfg = configs()
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (n, p)).astype(np.int32)


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k], prefix + (k,))]
    if isinstance(tree, tuple) and not hasattr(tree, "shape"):
        return [x for i, v in enumerate(tree) for x in flat(v, prefix + (i,))]
    return [(prefix, tuple(tree.shape), tuple(tree.logical), tree.init, str(tree.dtype))]


def _jax_padded(cache, max_len):
    """The JAX prefill cache in the decode layout: the self K/V padded to
    ``max_len`` positions, the cross K/V as they are."""
    k, v, kx, vx = cache["decoder"]
    pad = [(0, 0)] * 3 + [(0, max_len - k.shape[3]), (0, 0)]
    return {"decoder": (jnp.pad(k, pad), jnp.pad(v, pad), kx, vx)}


def _assert_cache(ours, ref):
    assert list(ours) == ["decoder"] and len(ours["decoder"]) == 4
    for a, b in zip(ours["decoder"], ref["decoder"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ------------------------------------------------------------ configs
def test_config_and_specs_match_jax():
    """Field for field, less the JAX-only knobs and the port's
    ``embed_scale``; the parameter and cache trees equal the JAX package's,
    full and reduced; the registry routes the family here."""
    j, p = jax_get_config(ARCH), get_config(ARCH)
    assert ARCH in ARCH_IDS
    assert {k: v for k, v in vars(p).items() if k != "embed_scale"} == \
        {k: v for k, v in vars(j).items() if k not in DROPPED}
    for jc, pc in ((j, p), (j.reduced(), p.reduced())):
        assert flat(encdec.abstract_params(pc)) == flat(jed.abstract_params(jc))
        for s in (1, 448):
            assert flat(encdec.abstract_cache(pc, 3, s)) == flat(jed.abstract_cache(jc, 3, s))
    assert registry.module_for(p) is encdec
    with pytest.raises(NotImplementedError, match="registry"):
        transformer.abstract_params(p)


def test_count_params_at_full_width_and_depth():
    j, p = jax_get_config(ARCH), port_config(ARCH)
    assert (p.num_layers, p.encoder_layers, p.d_model, p.frontend_tokens) == \
        (32, 32, 1280, 1500)
    assert registry.count_params(p) == jregistry.count_params(j) == 1_534_732_800
    assert p.param_count() == 1_534_732_800


def test_weights_of_both_stacks_carry_across(weights, port_weights):
    """The stacked ``encoder`` and ``decoder`` leaves become one dict of
    per-layer views per layer (not the VAE's HWIO convs, which share the
    names); the rest keeps its shape."""
    _, cfg = configs()
    for key, n in (("encoder", cfg.encoder_layers), ("decoder", cfg.num_layers)):
        assert len(port_weights[key]) == n
        for name, stacked in weights[key].items():
            for i, lp in enumerate(port_weights[key]):
                np.testing.assert_array_equal(lp[name].numpy(), stacked[i])
    for name in ("embedding", "enc_final_norm", "final_norm"):
        np.testing.assert_array_equal(port_weights[name].numpy(), weights[name])


# -------------------------------------------------------------- model
#: The sinusoid at the 1500 frame positions: a float32 angle near 1499 rad
#: has a rounding step of 2^-13 (1.2e-4), and the two frameworks may round
#: a position times a frequency (whose float32 ``exp`` may differ by an
#: ulp) a step apart: elements are held to two such steps (found 3.1e-5,
#: one step of an angle under 512 rad).
SINUSOID_ATOL = 2 * 2.0 ** -13


def test_sinusoid_matches_jax():
    pos = np.arange(1500, dtype=np.int32)
    for d in (32, 256, 1280):
        np.testing.assert_allclose(encdec._sinusoid(t(pos), d).numpy(),
                                   np.asarray(jed._sinusoid(jnp.asarray(pos), d)),
                                   atol=SINUSOID_ATOL, rtol=2e-5)


def test_encode_matches_jax(weights, port_weights):
    jcfg, cfg = configs()
    fr = frames(2)
    ours = encdec.encode(port_weights, t(fr), cfg)
    np.testing.assert_allclose(ours.numpy(),
                               np.asarray(jed.encode(weights, jnp.asarray(fr), jcfg)), **TOL)


@pytest.mark.parametrize("plen", [7, 300])
def test_prefill_and_decode_match_jax(weights, port_weights, plen):
    """Prefill over random frames: logits and the cache (the self K/V at
    ``max_len`` positions, the cross K/V of every layer); then three decode
    steps, each step's logits and cache, the cross K/V unchanged.  Prompts
    stay inside the published 448-token decoder context: past 2048 tokens
    the sinusoid's float32 angles carry rounding steps of 2.4e-4, which the
    two frameworks may round apart, and the logits differ by more than
    2e-5 for that reason alone."""
    jcfg, cfg = configs()
    max_len = max(MAX_LEN, plen + 3)
    toks, fr = prompts(2, plen, seed=plen), frames(2, seed=plen)
    jlogits, jcache = jed.prefill(weights, {"tokens": jnp.asarray(toks),
                                            "frames": jnp.asarray(fr)}, jcfg)
    logits, cache = encdec.prefill(port_weights, t(toks), cfg, frames=t(fr),
                                   max_len=max_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    jcache = _jax_padded(jcache, max_len)
    _assert_cache(cache, jcache)
    cross = [x.clone() for x in cache["decoder"][2:]]
    for cur in (plen, plen + 1, plen + 2):
        nxt = prompts(2, 1, seed=cur)[:, 0]
        jlogits, jcache = jed.decode_step(
            weights, jcache, {"tokens": jnp.asarray(nxt), "cur_index": jnp.int32(cur)},
            jcfg)
        logits = encdec.decode_step(port_weights, cache, t(nxt), cur, cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        _assert_cache(cache, jcache)
    for a, b in zip(cross, cache["decoder"][2:]):
        assert torch.equal(a, b)


def test_make_decode_cache_matches_jax(weights, port_weights):
    jcfg, cfg = configs()
    fr = frames(3, seed=5)
    ours = encdec.make_decode_cache(port_weights, t(fr), cfg, MAX_LEN)
    ref = jed.make_decode_cache(weights, jnp.asarray(fr), jcfg, MAX_LEN)
    _assert_cache(ours, ref)
    assert not ours["decoder"][0].any() and ours["decoder"][2].any()


def test_decode_takes_one_scalar_index(port_weights):
    """A 0-d tensor is the int it holds; a [B] vector raises, as the JAX
    package's decode takes a scalar; an index past the cache raises."""
    _, cfg = configs()
    toks = prompts(2, 4)
    nxt = t(prompts(2, 1, seed=9)[:, 0])
    _, cache = encdec.prefill(port_weights, t(toks), cfg, frames=t(frames(2)),
                              max_len=8)
    other = {"decoder": tuple(x.clone() for x in cache["decoder"])}
    a = encdec.decode_step(port_weights, cache, nxt, 4, cfg)
    b = encdec.decode_step(port_weights, other, nxt, torch.tensor(4), cfg)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="scalar"):
        encdec.decode_step(port_weights, cache, nxt, torch.tensor([5, 5]), cfg)
    with pytest.raises(ValueError, match="outside"):
        encdec.decode_step(port_weights, cache, nxt, 8, cfg)


# ------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def engine(port_weights):
    return ServingEngine(configs()[1], params=port_weights, max_len=MAX_LEN,
                         device="cpu")


def test_greedy_tokens_identical_to_jax(weights, engine):
    """Both engines prefill over zero frames and decode greedily."""
    jcfg, _ = configs()
    toks = prompts(2, 5, seed=14)
    ref = JaxEngine(jcfg, params=weights, max_len=MAX_LEN).generate(toks, steps=8)
    np.testing.assert_array_equal(engine.generate(toks, steps=8).tokens, ref.tokens)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_equals_generate_reference(engine, temperature):
    """The prefill-then-decode path against the token-at-a-time loop, which
    starts from ``make_decode_cache`` over the same zero frames."""
    toks = prompts(3, 6, seed=15)
    fast = engine.generate(toks, steps=7, temperature=temperature, seed=4)
    slow = engine.generate_reference(toks, steps=7, temperature=temperature, seed=4)
    np.testing.assert_array_equal(fast.tokens, slow.tokens)


def test_rows_of_a_batch_equal_their_batch_1_runs(engine):
    """Each row of a batch of 3 generates the tokens it generates alone
    (on the card the smoke holds the same at full width)."""
    toks = prompts(3, 5, seed=16)
    both = engine.generate(toks, steps=6).tokens
    for i in range(3):
        np.testing.assert_array_equal(both[i:i + 1],
                                      engine.generate(toks[i:i + 1], steps=6).tokens)


def test_engine_frames_reach_the_encoder(weights, engine):
    """``prefill(frames=)`` is the model's prefill over those frames; zeros
    by default."""
    jcfg, _ = configs()
    toks, fr = prompts(2, 6, seed=17), frames(2, seed=17)
    logits, _ = engine.prefill(toks, frames=fr)
    jlogits, _ = jed.prefill(weights, {"tokens": jnp.asarray(toks),
                                       "frames": jnp.asarray(fr)}, jcfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    zero, _ = engine.prefill(toks)
    jzero, _ = jed.prefill(weights, {"tokens": jnp.asarray(toks),
                                     "frames": jnp.zeros_like(jnp.asarray(fr))}, jcfg)
    np.testing.assert_allclose(zero.numpy(), np.asarray(jzero), **TOL)


# ------------------------------------------------------------ refusals
def test_slot_serving_is_refused_as_in_jax(engine, monkeypatch):
    """``init_slots`` raises the JAX engine's NotImplementedError, and so
    does the launcher's ``llm`` workflow for whisper."""
    with pytest.raises(NotImplementedError, match="built per request"):
        engine.init_slots(2)
    monkeypatch.setattr("sys.argv", ["serve", "--workflow", "llm", "--llm-arch", ARCH,
                                     "--profile", "small", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="built per request"):
        launcher.main()


def test_an_int8_cache_is_refused(monkeypatch, capsys):
    with pytest.raises(ValueError, match="audio"):
        dataclasses.replace(get_config(ARCH), cache_dtype="int8")
    with pytest.raises(ValueError, match="int8"):
        launcher.llm_config(ARCH, "port", "int8")
    monkeypatch.setattr("sys.argv", ["serve", "--workflow", "llm", "--llm-arch", ARCH,
                                     "--profile", "small", "--device", "cpu",
                                     "--cache-dtype", "int8"])
    with pytest.raises(SystemExit) as e:
        launcher.main()
    assert e.value.code == 2
    assert "no int8 layout" in capsys.readouterr().err

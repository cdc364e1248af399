"""gemma3's local/global layers held against the JAX package on the CPU.

The reduced gemma3-27b config keeps 2 layers, which the period layout turns
into 2 local tail layers and no period, so these tests take 8 layers and a
window of 16: one period of 5 local layers and 1 global one, then 2 local
tail layers, with ring caches of 16 slots at ``max_len`` 64.  A 20-token
prompt wraps its rings in the prefill and a 12-token one during decode.

Weights and inputs are made with numpy from a seed and fed to both
frameworks; the port gets the weights through ``params_from_numpy``.  The
JAX side runs its plain reference branches, as its own tests run it on the
CPU (windowed attention has no Pallas kernel there).  Tolerances: float32
2e-5 (docs/kernels.md); greedy tokens identical.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.models import transformer as jtf
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch.serve import check_served, llm_config
from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.serving import APP_LLM_DISAGG, ServingEngine, build_llm_disagg_set

#: Small shapes gain nothing from many intra-op threads; the suite's other
#: workers (some timing-sensitive) share the machine's cores.
torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-5)
MAX_LEN = 64
WINDOW = 16


def configs(**kw):
    """(JAX config, port config): gemma3-27b reduced, float32, 8 layers,
    window 16."""
    kw = dict(dtype="float32", num_layers=8, sliding_window=WINDOW, **kw)
    return (dataclasses.replace(jax_get_config("gemma3-27b").reduced(), **kw),
            dataclasses.replace(get_config("gemma3-27b").reduced(), **kw))


def numpy_params(spec, rng, name=""):
    """Normal with std 1/sqrt(fan_in) over the contracted axes (not the
    layer axis), the embedding 1/sqrt(d_model) (gemma scales it back up by
    sqrt(d_model)), 0.1 for the norm scales (zeros in the spec)."""
    if isinstance(spec, dict):
        return {k: numpy_params(spec[k], rng, k) for k in sorted(spec)}
    shape = spec.shape[1:] if spec.logical[0] == "layers" else spec.shape
    fan_in = int(np.prod(shape[:-1])) if name == "wo" else shape[0]
    if name == "embedding":
        fan_in = shape[1]
    std = 0.1 if spec.init == "zeros" else 1 / np.sqrt(fan_in)
    return (rng.standard_normal(spec.shape) * std).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = configs()
    return numpy_params(jtf.abstract_params(jcfg), np.random.default_rng(0))


@pytest.fixture(scope="module")
def port_weights(weights):
    return params_from_numpy(weights, device="cpu")


@pytest.fixture(scope="module")
def engine(port_weights):
    _, cfg = configs()
    return ServingEngine(cfg, params=port_weights, max_len=MAX_LEN, device="cpu")


@pytest.fixture(scope="module")
def jax_engine(weights):
    jcfg, _ = configs()
    return JaxEngine(jcfg, params=weights, max_len=MAX_LEN)


def t(x):
    return torch.from_numpy(np.array(x))


def prompts(n, p, seed=1):
    _, cfg = configs()
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n, p)).astype(np.int32)


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k], prefix + (k,))]
    if isinstance(tree, tuple) and not hasattr(tree, "shape"):
        return [x for i, v in enumerate(tree) for x in flat(v, prefix + (i,))]
    return [(prefix, tuple(tree.shape), tuple(tree.logical), tree.init,
             str(tree.dtype))]


# ------------------------------------------------------------ configs
def test_gemma3_config_matches_jax():
    """Field for field, less the JAX-only knobs, the source (the JAX
    package cites gemma-3-1b-pt for gemma-3-27b's widths) and the port's
    ``embed_scale``, which is set where the JAX package's name rule holds;
    28,417,621,760 parameters; 10 periods of (5 local, 1 global) and 2
    local tail layers."""
    dropped = {"use_pallas", "decode_unroll", "attn_causal_skip",
               "source"}
    j, p = jax_get_config("gemma3-27b"), get_config("gemma3-27b")
    assert p.source == "hf:google/gemma-3-27b-pt"
    assert {k: v for k, v in vars(p).items()
            if k not in ("source", "embed_scale")} == \
        {k: v for k, v in vars(j).items() if k not in dropped}
    assert p.embed_scale and j.name.startswith("gemma")
    assert p.param_count() == j.param_count() == 28_417_621_760
    assert transformer.layer_pattern(p) == jtf.layer_pattern(j) == (10, 6, 2)
    slots = transformer.layer_slots(p)
    assert [w for _, _, w in slots].count(0) == 10 and len(slots) == 62


@pytest.mark.parametrize("full", [False, True])
def test_layer_pattern_and_abstract_cache_match_jax(full):
    if full:
        j, p = jax_get_config("gemma3-27b"), get_config("gemma3-27b")
        batch, seq = 1, 2048
    else:
        j, p = configs()
        batch, seq = 3, MAX_LEN
    assert transformer.layer_pattern(p) == jtf.layer_pattern(j)
    assert [transformer._is_local(p, i) for i in range(6)] == \
        [jtf._is_local(j, i) for i in range(6)]
    assert flat(transformer.abstract_params(p)) == flat(jtf.abstract_params(j))
    ours = transformer.abstract_cache(p, batch, seq)
    assert flat(ours) == flat(jtf.abstract_cache(j, batch, seq))
    if full:   # 10 x 2048 + 52 x 1024 positions of 8 KiB: about 604 MB
        nbytes = sum(2 * np.prod(s.shape) for leaf in ours.values() for s in leaf)
        assert nbytes == (10 * 2048 + 52 * 1024) * 8192
    else:
        shapes = {k: tuple(v[0].shape) for k, v in ours.items()}
        assert shapes == {"local": (1, 5, 3, 2, WINDOW, 32),
                          "global": (1, 3, 2, MAX_LEN, 32),
                          "tail": (2, 3, 2, WINDOW, 32)}


def test_int8_cache_with_a_window_raises():
    _, cfg = configs()
    with pytest.raises(ValueError, match="gemma3"):
        dataclasses.replace(cfg, cache_dtype="int8")
    with pytest.raises(ValueError, match="gemma3"):
        llm_config("gemma3-27b", "port", "int8")


@pytest.mark.parametrize("d_model", [256, 5376])
def test_embedding_scale_rounds_as_jax_does(d_model):
    """sqrt(d_model) is taken in the embeddings' type: in bfloat16
    sqrt(5376) = 73.32 rounds to 73.5, and the port multiplies by that."""
    _, cfg = configs(d_model=d_model)
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((8, d_model)).astype(np.float32)
    toks = np.array([[1, 7, 3]], np.int32)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        ours = transformer._embed({"embedding": t(emb).to(dtype)}, t(toks), cfg)
        ref = jtf._embed({"embedding": jnp.asarray(emb, jdtype)},
                         dataclasses.replace(configs()[0], d_model=d_model),
                         jnp.asarray(toks), None)
        np.testing.assert_array_equal(ours.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))


# ---------------------------------------------------------- attention
def _qkv(seed, b, s, h, kv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


@pytest.mark.parametrize("causal", [True, False])
def test_windowed_attention_full_matches_jax(causal):
    q, k, v = _qkv(2, 2, 40, 4, 2, 32)
    ours = L.attention_full(t(q), t(k), t(v), causal=causal, window=WINDOW)
    ref = JL.attention_full(*map(jnp.asarray, (q, k, v)), causal=causal,
                            window=WINDOW, use_pallas=False)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_windowed_attention_blockwise_matches_jax():
    """S = 2112 = 64 x 33: the query block halves from 512 to 64; window
    64, so each block attends over a span of 128 keys."""
    q, k, v = _qkv(3, 1, 2112, 2, 1, 32)
    ours = L.attention_blockwise(t(q), t(k), t(v), causal=True, window=64)
    ref = JL.attention_blockwise(*map(jnp.asarray, (q, k, v)), causal=True,
                                 window=64, use_pallas=False)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    full = L.attention_full(t(q), t(k), t(v), causal=True, window=64)
    np.testing.assert_allclose(ours.numpy(), full.numpy(), **TOL)


#: ring decode indices: scalar before and after the wrap; per row, rows
#: before, at and after it
RING_CURS = [5, 15, 37, [3, 15, 16, 40]]


def _ring_inputs(seed, b, h=4, kv=2, d=32, w=WINDOW):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, d)).astype(np.float32),
            rng.standard_normal((b, kv, w, d)).astype(np.float32),
            rng.standard_normal((b, kv, w, d)).astype(np.float32))


def _cur(cur):
    return cur if isinstance(cur, int) else torch.tensor(cur, dtype=torch.int32)


@pytest.mark.parametrize("cur", RING_CURS)
def test_attention_decode_ring_matches_jax(cur):
    q, k, v = _ring_inputs(6, 4)
    jcur = jnp.int32(cur) if isinstance(cur, int) else jnp.asarray(cur, jnp.int32)
    ours = L.attention_decode_ring(t(q), t(k), t(v), _cur(cur))
    ref = JL.attention_decode_ring(*map(jnp.asarray, (q, k, v)), jcur)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("cur", RING_CURS)
def test_clamped_attention_decode_equals_the_ring(cur):
    """Before its first wrap a ring's valid slots are the prefix 0..cur,
    after it every slot: flash-decode at min(cur, w - 1) computes
    ``attention_decode_ring`` at cur."""
    q, k, v = _ring_inputs(7, 4)
    seen = min(cur, WINDOW - 1) if isinstance(cur, int) else \
        _cur(cur).clamp(max=WINDOW - 1)
    ours = L.attention_decode(t(q), t(k), t(v), seen)
    ring = L.attention_decode_ring(t(q), t(k), t(v), _cur(cur))
    np.testing.assert_allclose(ours.numpy(), ring.numpy(), **TOL)


# --------------------------------------------------------------- model
def _pad_like_engine(jcache, jcfg):
    """The JAX engine's zero pad of a prefill cache to the decode layout."""
    spec = jtf.abstract_cache(jcfg, 2, MAX_LEN)
    return {k: tuple(jnp.pad(x, [(0, n - c) for c, n in zip(x.shape, s.shape)])
                     for x, s in zip(jcache[k], spec[k])) for k in jcache}


def _assert_cache(ours, ref):
    assert set(ours) == set(ref)
    for leaf in ours:
        for a, b in zip(ours[leaf], ref[leaf]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("plen", [12, 20])
def test_prefill_and_decode_logits_match_jax(weights, port_weights, plen):
    """A 20-token prompt wraps the 16-slot rings in the prefill; a 12-token
    one wraps them during the 8 decode steps (a lockstep index, then per-row
    positions, one row behind the other)."""
    jcfg, cfg = configs()
    toks = prompts(2, plen, seed=plen)
    jlogits, jcache = jtf.prefill(weights, {"tokens": jnp.asarray(toks)}, jcfg)
    logits, cache = transformer.prefill(port_weights, t(toks), cfg, max_len=MAX_LEN)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    jcache = _pad_like_engine(jcache, jcfg)
    _assert_cache(cache, jcache)
    for i in range(8):
        cur = plen + i if i < 4 else [plen + i, plen + i - 3]
        jcur = jnp.int32(cur) if isinstance(cur, int) else jnp.asarray(cur, jnp.int32)
        nxt = prompts(2, 1, seed=100 + i)[:, 0]
        jlogits, jcache = jtf.decode_step(
            weights, jcache, {"tokens": jnp.asarray(nxt), "cur_index": jcur}, jcfg)
        logits = transformer.decode_step(port_weights, cache, t(nxt), _cur(cur), cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        _assert_cache(cache, jcache)


@pytest.mark.parametrize("plen", [12, 20])
def test_prefill_cache_matches_the_jax_engine(engine, jax_engine, plen):
    """The serving engines' prefill caches: the port writes the ``max_len``
    layout straight away, the JAX engine pads its prefill cache to it."""
    toks = prompts(2, plen, seed=plen + 1)
    jlogits, jcache = jax_engine.prefill(toks)
    logits, cache = engine.prefill(toks)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    _assert_cache(cache, jcache)


@pytest.mark.parametrize("plen", [12, 20])
def test_greedy_tokens_identical_to_jax(engine, jax_engine, plen):
    toks = prompts(2, plen, seed=plen + 2)
    ref = jax_engine.generate(toks, steps=8)
    ours = engine.generate(toks, steps=8)
    np.testing.assert_array_equal(ours.tokens, ref.tokens)
    np.testing.assert_array_equal(engine.generate_reference(toks, steps=8).tokens,
                                  ours.tokens)


def test_served_tokens_equal_solo_generate(engine):
    """Four requests, greedy and sampled, prompts of 5 to 30 tokens (rings
    wrapped in prefill and in decode), through two slots of the port's
    llm_disagg set: nothing dropped, every stream equal to its solo
    ``generate``; each request ships its local, global and tail leaves."""
    ws, dec = build_llm_disagg_set(engine, name="gemma", max_slots=2, segment_len=3)
    reqs = [{"prompt": prompts(1, p, seed=30 + i), "steps": 8,
             "temperature": 0.7 * (i % 2), "seed": 300 + i}
            for i, p in enumerate([12, 20, 5, 30])]
    with ws:
        p = ws.proxies[0]
        res = [p.wait_result(u, timeout_s=60)
               for u in [p.submit(APP_LLM_DISAGG, r) for r in reqs]]
        stats = ws.transport_stats()
    check_served(engine, reqs, res)
    assert stats.dropped == 0 and ws.dead_uids() == set()
    assert dec.stats["completed"] == 4
    cfg = engine.cfg
    cache = (5 * WINDOW + MAX_LEN + 2 * WINDOW) * 2 * cfg.resolved_kv_heads * 32 * 4
    assert stats.kv_bytes == 4 * (cache + 4 * cfg.vocab_padded)

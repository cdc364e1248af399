"""The port's LLM serving slice held against the JAX package on the CPU, on
the reduced float32 qwen3-1.7b config, and on chatglm3-6b's reduced config
(2d rotary over half the head; 4 query heads over 1 kv head) and a variant
of it with 16 query heads over 1 (groups of 16, as the full model's 32 over
2).

Weights and inputs are made with numpy from a seed and fed to both
frameworks; the port gets the weights through ``params_from_numpy``.  The
JAX side runs as its own tests run it on the CPU: the Pallas decode kernels
in interpret mode where a test names them, the model through its plain
reference branches.  Tolerances: float32 2e-5; the int8 decode 1e-4 against
the dequantized-cache oracle (docs/kernels.md); greedy tokens identical.
Tokens at temperature > 0 follow the port's own RNG contract and are held
against the port's own paths.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.decode_attention import ops as jops
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_oracle
from repro.models import layers as JL
from repro.models import transformer as jtf
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.messaging import KVPages, WorkflowMessage
from repro_torch.kernels import decode_attention as K
from repro_torch.launch.serve import check_served
from repro_torch.models import layers as L
from repro_torch.models import registry, transformer
from repro_torch.serving import APP_LLM_DISAGG, ServingEngine, build_llm_disagg_set
from repro_torch.serving.disagg import (
    DEFAULT_RING_BYTES,
    from_page,
    largest_message_bytes,
    ring_bytes_for,
    to_page,
)

#: Small shapes gain nothing from many intra-op threads; the suite's other
#: workers (some timing-sensitive) share the machine's cores.
torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-5)
INT8_TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN = 32


def configs(cache_dtype=""):
    """(JAX config, port config): reduced qwen3-1.7b in float32."""
    j = dataclasses.replace(jax_get_config("qwen3-1.7b").reduced(),
                            dtype="float32", cache_dtype=cache_dtype)
    p = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                            dtype="float32", cache_dtype=cache_dtype)
    return j, p


def numpy_params(spec, rng, name=""):
    """A numpy weight tree for a JAX ParamSpec tree: normal with std
    1/sqrt(fan_in) over the contracted axes (not the layer axis), so that
    activations stay O(1) and 2e-5 measures float32 rounding; the embedding
    1/sqrt(d_model), so that the tied logits are O(1) and their top values
    well apart; 0.1 for the norm scales (zeros in the spec), so ``1 + w`` is
    exercised."""
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


def t(x):
    return torch.from_numpy(np.array(x))


def prompts(n, p, seed=1):
    _, cfg = configs()
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n, p)).astype(np.int32)


# ------------------------------------------------------------- configs
def test_config_and_param_specs_match_jax():
    """Field for field, less the JAX-only knobs, the port's ``embed_scale``
    (the JAX package's name rule) and the source: the JAX package cites
    hf:Qwen/Qwen3-8B for this config, whose widths are Qwen3-1.7B's, and the
    port cites the model it is."""
    dropped = {"use_pallas", "decode_unroll", "attn_causal_skip",
               "source"}
    assert get_config("qwen3-1.7b").source == "hf:Qwen/Qwen3-1.7B"
    for reduce in (False, True):
        j = jax_get_config("qwen3-1.7b")
        p = get_config("qwen3-1.7b")
        if reduce:
            j, p = j.reduced(), p.reduced()
        assert {k: v for k, v in vars(p).items()
                if k not in ("source", "embed_scale")} == \
            {k: v for k, v in vars(j).items() if k not in dropped}
        assert not p.embed_scale and not j.name.startswith("gemma")
        assert (p.vocab_padded, p.resolved_head_dim, p.resolved_kv_heads) == \
            (j.vocab_padded, j.resolved_head_dim, j.resolved_kv_heads)

        def flat(tree, prefix=()):
            if isinstance(tree, dict):
                return [x for k in sorted(tree) for x in flat(tree[k], prefix + (k,))]
            if isinstance(tree, tuple) and not hasattr(tree, "shape"):
                return [x for i, v in enumerate(tree) for x in flat(v, prefix + (i,))]
            return [(prefix, tuple(tree.shape), tuple(tree.logical), tree.init,
                     str(tree.dtype))]

        assert flat(transformer.abstract_params(p)) == flat(jtf.abstract_params(j))
        for cd in ("", "int8"):
            pc = dataclasses.replace(p, cache_dtype=cd)
            jc = dataclasses.replace(j, cache_dtype=cd)
            assert flat(transformer.abstract_cache(pc, 3, 64)) == \
                flat(jtf.abstract_cache(jc, 3, 64))
    assert 1.70e9 < get_config("qwen3-1.7b").param_count() < 1.75e9


def test_unported_configs_raise():
    """The families the transformer does not carry: whisper's
    encoder-decoder (audio) and zamba2's Mamba2 layers (hybrid) have
    modules of their own, to which its message points."""
    for name, kw in (("audio", dict(family="audio")),
                     ("hybrid", dict(family="hybrid"))):
        cfg = dataclasses.replace(get_config("qwen3-1.7b"), name=name, **kw)
        with pytest.raises(NotImplementedError, match="models/registry.py"):
            transformer.abstract_params(cfg)


@pytest.mark.parametrize("arch,family,module", [
    ("whisper-large-v3", "audio", "encdec"), ("zamba2-1.2b", "hybrid", "mamba2")])
def test_registry_routes_audio_and_hybrid(arch, family, module):
    """``registry.abstract_params`` takes both families to their modules; an
    unknown family raises, naming the ones the port carries."""
    from repro_torch.models import encdec, mamba2

    cfg = get_config(arch)
    mod = {"encdec": encdec, "mamba2": mamba2}[module]
    assert cfg.family == family and registry.module_for(cfg) is mod
    assert registry.abstract_params(cfg) == mod.abstract_params(cfg)
    with pytest.raises(NotImplementedError, match="carries"):
        registry.module_for(dataclasses.replace(cfg, family="unknown"))


def test_weights_of_a_jax_tree_carry_across(weights, port_weights):
    """``params_from_numpy`` on a JAX ``abstract_params`` tree: the stacked
    ``layers`` leaves become one dict of per-layer views per layer, the rest
    keeps its shape, and every number arrives unchanged."""
    _, cfg = configs()
    assert set(port_weights) == set(weights)
    assert len(port_weights["layers"]) == cfg.num_layers
    for name, stacked in weights["layers"].items():
        for i, lp in enumerate(port_weights["layers"]):
            np.testing.assert_array_equal(lp[name].numpy(), stacked[i])
    for name in ("embedding", "final_norm"):
        np.testing.assert_array_equal(port_weights[name].numpy(), weights[name])


# -------------------------------------------------------------- layers
@pytest.mark.parametrize("rotary_dim", [0, 16])
@pytest.mark.parametrize("table", ["shared", "per_row"])
def test_apply_rope_matches_jax(rotary_dim, table):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    pos = (np.arange(5)[None] + np.array([[0], [7]])).astype(np.int32)
    if table == "shared":
        pos = pos[0]
    sin, cos = L.rope_freqs(t(pos), 32, 1e6, rotary_dim or 32)
    jsin, jcos = JL.rope_freqs(jnp.asarray(pos), 32, 1e6, rotary_dim or 32)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), **TOL)
    ours = L.apply_rope(t(x), sin, cos, rotary_dim)
    ref = JL.apply_rope(jnp.asarray(x), jsin, jcos, rotary_dim)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_qk_rms_norm_and_swiglu_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    w = (rng.standard_normal(32) * 0.1).astype(np.float32)
    np.testing.assert_allclose(L.rms_norm(t(x), t(w), 1e-6).numpy(),
                               np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(w))),
                               **TOL)
    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    wg, wu = (rng.standard_normal((16, 24)).astype(np.float32) for _ in range(2))
    wd = rng.standard_normal((24, 16)).astype(np.float32)
    np.testing.assert_allclose(
        L.swiglu(t(h), t(wg), t(wu), t(wd)).numpy(),
        np.asarray(JL.swiglu(*map(jnp.asarray, (h, wg, wu, wd)))), **TOL)


def test_quantize_token_kv_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 3, 5, 32)).astype(np.float32)
    q, s = L.quantize_token_kv(t(x))
    jq, js = JL.quantize_token_kv(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    kq, ks = K.quantize_kv(t(x))
    jkq, jks = jops.quantize_kv(jnp.asarray(x))
    np.testing.assert_array_equal(kq.numpy(), np.asarray(jkq))
    np.testing.assert_allclose(ks.numpy(), np.asarray(jks), rtol=1e-7, atol=0)


# ------------------------------------------------------ decode kernels
DECODE_CASES = [
    # b, s, h, kv, d, cur (int: scalar index; list: one per row)
    (2, 64, 4, 2, 32, 37),
    (2, 50, 8, 2, 64, [49, 0]),
    (3, 40, 4, 4, 32, [5, 39, 17]),
    (1, 96, 16, 8, 128, 95),
    (2, 48, 21, 3, 64, [47, 6]),        # groups of 7 (internvl2-1b's 14 over 2)
    (3, 40, 24, 8, 32, [39, 0, 17]),    # groups of 3 (granite-moe's 24 over 8)
]


def _decode_inputs(seed, b, s, h, kv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    return q, k, v


def _per_row(fn, cur, b, *arrays):
    """A Pallas kernel (scalar index only) run row by row for a [B] index."""
    if isinstance(cur, int):
        return np.asarray(fn(*map(jnp.asarray, arrays), jnp.int32(cur)))
    return np.concatenate([
        np.asarray(fn(*(jnp.asarray(a[i:i + 1]) for a in arrays), jnp.int32(c)))
        for i, c in enumerate(cur)])


def _cur(cur):
    return cur if isinstance(cur, int) else torch.tensor(cur, dtype=torch.int32)


@pytest.mark.parametrize("b,s,h,kv,d,cur", DECODE_CASES)
def test_decode_plain_matches_pallas_interpret(b, s, h, kv, d, cur):
    q, k, v = _decode_inputs(5, b, s, h, kv, d)
    kc, vc = k.transpose(0, 2, 1, 3).copy(), v.transpose(0, 2, 1, 3).copy()
    native = K.decode_attention(t(q), t(k), t(v), _cur(cur))
    serving = K.decode_attention_cache(t(q), t(kc), t(vc), _cur(cur))
    ref = _per_row(lambda *a: jops.decode_attention(*a, interpret=True), cur, b, q, k, v)
    ref_c = _per_row(lambda *a: jops.decode_attention_cache(*a, interpret=True),
                     cur, b, q, kc, vc)
    np.testing.assert_allclose(native.numpy(), ref, **TOL)
    np.testing.assert_allclose(serving.numpy(), ref_c, **TOL)
    # the model's entry point, against the JAX reference branch (which
    # takes the [B] index itself)
    jcur = jnp.int32(cur) if isinstance(cur, int) else jnp.asarray(cur, jnp.int32)
    ours = L.attention_decode(t(q), t(kc), t(vc), _cur(cur))
    np.testing.assert_allclose(
        ours.numpy(), np.asarray(JL.attention_decode(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jcur,
            use_pallas=False)), **TOL)


@pytest.mark.parametrize("b,s,h,kv,d,cur", DECODE_CASES)
def test_decode_int8_plain_matches_pallas_and_oracle(b, s, h, kv, d, cur):
    q, k, v = _decode_inputs(6, b, s, h, kv, d)
    kq, ks = jops.quantize_kv(jnp.asarray(k))
    vq, vs = jops.quantize_kv(jnp.asarray(v))
    kq, ks, vq, vs = map(np.asarray, (kq, ks, vq, vs))
    kqc, vqc = kq.transpose(0, 2, 1, 3).copy(), vq.transpose(0, 2, 1, 3).copy()
    native = K.decode_attention_quantized(t(q), t(kq), t(vq), t(ks), t(vs), _cur(cur))
    serving = K.decode_attention_int8_cache(t(q), t(kqc), t(vqc), t(ks), t(vs),
                                            _cur(cur))
    pallas = _per_row(lambda *a: jops.decode_attention_quantized(*a, interpret=True),
                      cur, b, q, kq, vq, ks, vs)
    pallas_c = _per_row(lambda *a: jops.decode_attention_int8_cache(*a, interpret=True),
                        cur, b, q, kqc, vqc, ks, vs)
    np.testing.assert_allclose(native.numpy(), pallas, **TOL)
    np.testing.assert_allclose(serving.numpy(), pallas_c, **TOL)
    # the dequantized-cache oracle
    kd = kq.astype(np.float32) * ks.transpose(0, 2, 1)[..., None]
    vd = vq.astype(np.float32) * vs.transpose(0, 2, 1)[..., None]
    oracle = _per_row(jax_oracle, cur, b, q, kd, vd)
    np.testing.assert_allclose(native.numpy(), oracle, **INT8_TOL)
    np.testing.assert_allclose(serving.numpy(), oracle, **INT8_TOL)


#: the kernel's chunk edges at a small size: a float32 cache at D 32 splits
#: into chunks of K.chunk_len(4, 32) = 256 positions; rows end at CHUNK - 1,
#: CHUNK, CHUNK + 1 and S - 1
CHUNK_EDGE_CASE = (4, 600, 4, 2, 32, [255, 256, 257, 599])


@pytest.mark.parametrize("b,s,h,kv,d,cur", DECODE_CASES + [CHUNK_EDGE_CASE])
def test_decode_chunked_order_matches_plain_and_pallas(b, s, h, kv, d, cur):
    """The kernel's order (fixed chunks, each with its own m, l and acc,
    combined in ascending order) gives the plain softmax and the Pallas
    kernel's output: at the kernel's chunk, and at 16-position chunks where
    every case spans several."""
    assert K.chunk_len(4, 32) == 256
    q, k, v = _decode_inputs(7, b, s, h, kv, d)
    kc, vc = k.transpose(0, 2, 1, 3).copy(), v.transpose(0, 2, 1, 3).copy()
    qg = t(q).reshape(b, kv, h // kv, d)
    plain = K.decode_ref(qg, t(kc), t(vc), _cur(cur)).reshape(b, h, d)
    pallas = _per_row(lambda *a: jops.decode_attention_cache(*a, interpret=True),
                      cur, b, q, kc, vc)
    for chunk in (0, 16):
        native = K.decode_chunked_ref(qg, t(k), t(v), _cur(cur), seq_axis=1, chunk=chunk)
        serving = K.decode_chunked_ref(qg, t(kc), t(vc), _cur(cur), chunk=chunk)
        for got in (native, serving):
            np.testing.assert_allclose(got.reshape(b, h, d).numpy(), plain.numpy(), **TOL)
            np.testing.assert_allclose(got.reshape(b, h, d).numpy(), pallas, **TOL)


@pytest.mark.parametrize("b,s,h,kv,d,cur", DECODE_CASES + [CHUNK_EDGE_CASE])
def test_decode_int8_chunked_order_matches_plain_and_pallas(b, s, h, kv, d, cur):
    """The same over the int8 cache: the k scale on the scores and the v
    scale on the probabilities inside each chunk."""
    q, k, v = _decode_inputs(8, b, s, h, kv, d)
    kq, ks = map(np.asarray, jops.quantize_kv(jnp.asarray(k)))
    vq, vs = map(np.asarray, jops.quantize_kv(jnp.asarray(v)))
    kqc, vqc = kq.transpose(0, 2, 1, 3).copy(), vq.transpose(0, 2, 1, 3).copy()
    qg = t(q).reshape(b, kv, h // kv, d)
    plain = K.decode_int8_ref(qg, t(kqc), t(vqc), t(ks), t(vs), _cur(cur)).reshape(b, h, d)
    pallas = _per_row(lambda *a: jops.decode_attention_int8_cache(*a, interpret=True),
                      cur, b, q, kqc, vqc, ks, vs)
    for chunk in (0, 16):
        native = K.decode_chunked_ref(qg, t(kq), t(vq), _cur(cur), seq_axis=1,
                                      k_scale=t(ks), v_scale=t(vs), chunk=chunk)
        serving = K.decode_chunked_ref(qg, t(kqc), t(vqc), _cur(cur), k_scale=t(ks),
                                       v_scale=t(vs), chunk=chunk)
        for got in (native, serving):
            np.testing.assert_allclose(got.reshape(b, h, d).numpy(), plain.numpy(), **TOL)
            np.testing.assert_allclose(got.reshape(b, h, d).numpy(), pallas, **TOL)


# --------------------------------------------------------------- model
def _jax_padded(cache, max_len):
    pad = lambda x: jnp.pad(x, [(0, 0)] * 3 + [(0, max_len - x.shape[3])]
                            + [(0, 0)] * (x.ndim - 4))
    return {"layers": tuple(pad(x) for x in cache["layers"])}


@pytest.mark.parametrize("cache_dtype", ["", "int8"])
def test_prefill_and_decode_logits_match_jax(weights, port_weights, cache_dtype):
    jcfg, cfg = configs(cache_dtype)
    toks = prompts(2, 7)
    jlogits, jcache = jtf.prefill(weights, {"tokens": jnp.asarray(toks)}, jcfg)
    logits, cache = transformer.prefill(port_weights, t(toks), cfg, max_len=MAX_LEN)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    jcache = _jax_padded(jcache, MAX_LEN)
    for ours, ref in zip(cache["layers"], jcache["layers"]):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    # decode: a lockstep (int) step, then per-row positions
    for cur, jcur in ((7, jnp.int32(7)), (torch.tensor([8, 3], dtype=torch.int32),
                                           jnp.asarray([8, 3], jnp.int32))):
        nxt = prompts(2, 1, seed=9)[:, 0]
        jlogits, jcache = jtf.decode_step(
            weights, jcache, {"tokens": jnp.asarray(nxt), "cur_index": jcur}, jcfg)
        logits = transformer.decode_step(port_weights, cache, t(nxt), cur, cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        for ours, ref in zip(cache["layers"], jcache["layers"]):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("cache_dtype", ["", "int8"])
def test_generate_greedy_tokens_identical_to_jax(weights, port_weights, cache_dtype):
    jcfg, cfg = configs(cache_dtype)
    toks = prompts(2, 5, seed=2)
    ref = JaxEngine(jcfg, params=weights, max_len=MAX_LEN).generate(toks, steps=8)
    ours = ServingEngine(cfg, params=port_weights, max_len=MAX_LEN,
                         device="cpu").generate(toks, steps=8)
    np.testing.assert_array_equal(ours.tokens, ref.tokens)


# ---------------------------------------------------------- RNG contract
@pytest.fixture(scope="module")
def engine(port_weights):
    _, cfg = configs()
    return ServingEngine(cfg, params=port_weights, max_len=MAX_LEN, device="cpu")


def test_sampling_paths_agree_at_temperature(engine):
    """At temperature 0.7: solo and batched ``generate``, the token-at-a-time
    ``generate_reference``, and slot decode (any slot, any segment length)
    give identical tokens."""
    toks = prompts(3, 5, seed=7)
    steps, seed = 9, 11
    batched = engine.generate(toks, steps=steps, temperature=0.7, seed=seed).tokens
    ref = engine.generate_reference(toks, steps=steps, temperature=0.7, seed=seed)
    np.testing.assert_array_equal(batched, ref.tokens)
    solo = engine.generate(toks[:1], steps=steps, temperature=0.7, seed=seed).tokens
    np.testing.assert_array_equal(solo, batched[:1])
    assert not np.array_equal(batched[:, 5:], engine.generate(
        toks, steps=steps, temperature=0.7, seed=seed + 1).tokens[:, 5:])

    logits, cache = engine.prefill(toks[:1])
    for slot, seg in ((2, 3), (0, 4)):
        state = engine.init_slots(4)
        state = engine.insert_slot(state, slot, cache, logits[0], start=5,
                                   seed=seed, steps=steps, temperature=0.7)
        got = []
        while len(got) < steps:
            state, out, adv = engine.decode_segment(state, seg)
            got.extend(int(x) for x in out[adv[:, slot], slot])
        np.testing.assert_array_equal(np.concatenate([toks[0], got[:steps]]), solo[0])


# -------------------------------------------------------- disaggregation
def test_disagg_serves_tokens_equal_to_solo_generate(engine):
    """Two-stage prefill -> decode over the port's fabric, four requests
    sharing two slots, greedy and sampled: nothing dropped, every result
    equal to a solo ``generate``."""
    ws, dec = build_llm_disagg_set(engine, name="e2e", max_slots=2, segment_len=3)
    reqs = [{"prompt": prompts(1, 4 + i, seed=20 + i), "steps": 6,
             "temperature": 0.7 * (i % 2), "seed": 100 + i} for i in range(4)]
    with ws:
        p = ws.proxies[0]
        uids = [p.submit(APP_LLM_DISAGG, r) for r in reqs]
        res = [p.wait_result(u, timeout_s=60) for u in uids]
        stats = ws.transport_stats()
    check_served(engine, reqs, res)
    assert stats.dropped == 0 and ws.dead_uids() == set()
    assert dec.stats["completed"] == 4 and dec.stats["max_resident"] == 2
    assert stats.kv_pages >= 4 and stats.kv_bytes > 0


def test_check_served_refuses_a_stream_that_differs(engine):
    req = {"prompt": prompts(1, 4, seed=30), "steps": 3, "temperature": 0.7,
           "seed": 5}
    out = engine.generate(req["prompt"], steps=3, temperature=0.7, seed=5).tokens
    check_served(engine, [req], [out])
    bad = out.copy()
    bad[0, -1] = (bad[0, -1] + 1) % engine.cfg.vocab_size
    with pytest.raises(AssertionError, match="request 0"):
        check_served(engine, [req], [bad])


def test_bf16_page_ships_as_int16_view_bit_for_bit():
    x = torch.randn(2, 1, 3, 8, dtype=torch.float32).to(torch.bfloat16)
    page = to_page(x)
    assert page.dtype == np.int16
    msg = WorkflowMessage.new(app_id=1, payload=KVPages(
        meta={"page_dtypes": ["bfloat16"]}, pages=[page]))
    out = WorkflowMessage.unpack(msg.pack()).payload
    back = from_page(out.pages[0], out.meta["page_dtypes"][0], "cpu")
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), x.view(torch.int16))


def test_inbox_rings_hold_a_full_width_cache(engine):
    """At qwen3-1.7b's widths a max_len 1024 bfloat16 cache is 117.4 MB, and
    over 7x the JAX package's 16 MiB ring: each inbox is sized to 4 of its
    largest message."""
    full = get_config("qwen3-1.7b")
    big = largest_message_bytes(full, 1024)
    cache = 28 * 2 * 8 * 1024 * 128 * 2
    assert cache == 117_440_512 and big > cache + 4 * full.vocab_padded
    assert big > 7 * DEFAULT_RING_BYTES
    assert ring_bytes_for(full, 1024) == 4 * big
    int8 = dataclasses.replace(full, cache_dtype="int8")
    assert largest_message_bytes(int8, 1024) < big / 1.9
    ws, _ = build_llm_disagg_set(engine, name="rings")
    sizes = {n: i.inbox.buf_size for n, i in ws.instances.items()}
    assert sizes["rings.decode0"] == ring_bytes_for(engine.cfg, MAX_LEN)
    assert sizes["rings.decode0"] >= 4 * largest_message_bytes(engine.cfg, MAX_LEN)
    assert sizes["rings.prefill0"] >= 4 * 4 * MAX_LEN


# ------------------------------------------------------------ chatglm3-6b
#: chatglm3's reduced config keeps its 2d rotary and its GQA ratio (4 query
#: heads over 1 kv head); "g16" has the full model's groups of 16 query
#: heads per kv head
CHATGLM = {"reduced": {}, "g16": dict(num_heads=16, num_kv_heads=1)}


def chatglm_configs(variant, cache_dtype=""):
    """(JAX config, port config): reduced chatglm3-6b in float32."""
    kw = dict(CHATGLM[variant], dtype="float32", cache_dtype=cache_dtype)
    return (dataclasses.replace(jax_get_config("chatglm3-6b").reduced(), **kw),
            dataclasses.replace(get_config("chatglm3-6b").reduced(), **kw))


@pytest.fixture(scope="module", params=sorted(CHATGLM))
def chatglm(request):
    """(variant, numpy weights, port weights)."""
    jcfg, _ = chatglm_configs(request.param)
    w = numpy_params(jtf.abstract_params(jcfg), np.random.default_rng(11))
    return request.param, w, params_from_numpy(w, device="cpu")


def test_chatglm3_config_matches_jax():
    """Field for field, less the JAX-only knobs and the port's
    ``embed_scale`` (the JAX package's name rule); 6,243,454,976 parameters,
    and 1 KiB of bfloat16 cache per token and layer."""
    dropped = {"use_pallas", "decode_unroll", "attn_causal_skip"}
    j, p = jax_get_config("chatglm3-6b"), get_config("chatglm3-6b")
    assert {k: v for k, v in vars(p).items() if k != "embed_scale"} == \
        {k: v for k, v in vars(j).items() if k not in dropped}
    assert not p.embed_scale and not j.name.startswith("gemma")
    assert p.param_count() == j.param_count() == 6_243_454_976
    assert p.rope_2d and p.num_heads // p.resolved_kv_heads == 16
    kv = transformer.abstract_cache(p, 1, 1)["layers"][0]
    assert 2 * np.prod(kv.shape) * 2 // p.num_layers == 1024


@pytest.mark.parametrize("variant", sorted(CHATGLM))
def test_chatglm3_param_and_cache_specs_match_jax(variant):
    jcfg, cfg = chatglm_configs(variant)
    assert cfg.num_heads // cfg.resolved_kv_heads == (16 if variant == "g16" else 4)

    def flat(tree, prefix=()):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in flat(tree[k], prefix + (k,))]
        if isinstance(tree, tuple) and not hasattr(tree, "shape"):
            return [x for i, v in enumerate(tree) for x in flat(v, prefix + (i,))]
        return [(prefix, tuple(tree.shape), tuple(tree.logical), tree.init,
                 str(tree.dtype))]

    assert flat(transformer.abstract_params(cfg)) == flat(jtf.abstract_params(jcfg))
    for cd in ("", "int8"):
        pc, jc = (dataclasses.replace(c, cache_dtype=cd) for c in (cfg, jcfg))
        assert flat(transformer.abstract_cache(pc, 3, 64)) == \
            flat(jtf.abstract_cache(jc, 3, 64))


@pytest.mark.parametrize("cache_dtype", ["", "int8"])
def test_chatglm3_prefill_and_decode_logits_match_jax(chatglm, cache_dtype):
    """Prefill logits and cache, then three decode steps (a lockstep index,
    then per-row positions twice), each step's logits and cache."""
    variant, weights, port_weights = chatglm
    jcfg, cfg = chatglm_configs(variant, cache_dtype)
    toks = prompts(2, 9, seed=12)
    jlogits, jcache = jtf.prefill(weights, {"tokens": jnp.asarray(toks)}, jcfg)
    logits, cache = transformer.prefill(port_weights, t(toks), cfg, max_len=MAX_LEN)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    jcache = _jax_padded(jcache, MAX_LEN)
    for cur in (9, [10, 4], [11, 5]):
        jcur = jnp.int32(cur) if isinstance(cur, int) else jnp.asarray(cur, jnp.int32)
        nxt = prompts(2, 1, seed=13 + len(str(cur)))[:, 0]
        jlogits, jcache = jtf.decode_step(
            weights, jcache, {"tokens": jnp.asarray(nxt), "cur_index": jcur}, jcfg)
        logits = transformer.decode_step(port_weights, cache, t(nxt), _cur(cur), cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        for ours, ref in zip(cache["layers"], jcache["layers"]):
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("cache_dtype", ["", "int8"])
def test_chatglm3_greedy_tokens_identical_to_jax(chatglm, cache_dtype):
    variant, weights, port_weights = chatglm
    jcfg, cfg = chatglm_configs(variant, cache_dtype)
    toks = prompts(2, 6, seed=14)
    ref = JaxEngine(jcfg, params=weights, max_len=MAX_LEN).generate(toks, steps=8)
    ours = ServingEngine(cfg, params=port_weights, max_len=MAX_LEN,
                         device="cpu").generate(toks, steps=8)
    np.testing.assert_array_equal(ours.tokens, ref.tokens)


def test_chatglm3_serves_tokens_equal_to_solo_generate(chatglm):
    """Four requests, greedy and sampled, through two slots of the port's
    llm_disagg set: nothing dropped, every stream equal to its solo
    ``generate``."""
    variant, _, port_weights = chatglm
    _, cfg = chatglm_configs(variant)
    engine = ServingEngine(cfg, params=port_weights, max_len=MAX_LEN, device="cpu")
    ws, dec = build_llm_disagg_set(engine, name=f"glm_{variant}", max_slots=2,
                                   segment_len=3)
    reqs = [{"prompt": prompts(1, 3 + 4 * i, seed=40 + i), "steps": 6,
             "temperature": 0.7 * (i % 2), "seed": 200 + i} for i in range(4)]
    with ws:
        p = ws.proxies[0]
        res = [p.wait_result(u, timeout_s=60)
               for u in [p.submit(APP_LLM_DISAGG, r) for r in reqs]]
        stats = ws.transport_stats()
    check_served(engine, reqs, res)
    assert stats.dropped == 0 and ws.dead_uids() == set()
    assert dec.stats["completed"] == 4

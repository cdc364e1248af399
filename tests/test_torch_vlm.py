"""internvl2-1b's patch embeddings and deepseek-67b's profile held against
the JAX package on the CPU.

internvl2-1b is the dense decoder with precomputed patch embeddings
[B, min(frontend_tokens, S), d_model] pasted over the first positions of a
prefill (the vision encoder is a stub, as in the JAX package); decode
injects none.  Its reduced config has 4 query heads over 1 (groups of 4);
"internvl2 g7" has the full model's 14 over 2 (groups of 7).  deepseek-67b
is the dense decoder at new widths, served on one card at 38 of its 95
layers (``configs.port_config``); its reduced config runs here too.

Weights and inputs are made with numpy from a seed and fed to both
frameworks; the port gets the weights through ``params_from_numpy``.  The
JAX side runs its plain reference branches, as its own tests run it on the
CPU.  Tolerances: float32 2e-5 (docs/kernels.md); with the int8 cache
one quantum in the cache and 1e-3 in the decode logits
(``INT8_LOGIT_TOL``); greedy tokens identical.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jtf
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_config, port_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch.serve import check_served, llm_config
from repro_torch.models import registry, transformer
from repro_torch.serving import APP_LLM_DISAGG, ServingEngine, build_llm_disagg_set
from repro_torch.serving.disagg import largest_message_bytes, ring_bytes_for

#: Small shapes gain nothing from many intra-op threads; the suite's other
#: workers (some timing-sensitive) share the machine's cores.
torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-5)
#: The int8 cache: both sides quantize k and v of each new token by
#: round(x / scale), and x differs between them by float32 rounding, so an
#: x that lies within that of a .5 boundary rounds one quantum apart (seen
#: once in 8,192 values of a decode step: reduced deepseek-67b, layer 1).
#: The int8 values are held to one quantum and the logits to what a
#: quantum moves them (3.9e-4 there).
INT8_LOGIT_TOL = dict(atol=1e-3, rtol=1e-3)
MAX_LEN = 32
DROPPED = {"use_pallas", "decode_unroll", "attn_causal_skip"}

VARIANTS = {
    "internvl2": ("internvl2-1b", {}),
    "internvl2 g7": ("internvl2-1b", dict(num_heads=14, num_kv_heads=2)),
    "deepseek-67b": ("deepseek-67b", {}),
}


def configs(variant, cache_dtype=""):
    """(JAX config, port config): the variant's reduced config in float32."""
    arch, kw = VARIANTS[variant]
    kw = dict(kw, dtype="float32", cache_dtype=cache_dtype)
    return (dataclasses.replace(jax_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def numpy_params(spec, rng, name=""):
    """Normal with std 1/sqrt(fan_in) over the contracted axes (not the
    layer axis), the embedding 1/sqrt(d_model), 0.1 for the norm scales
    (zeros in the spec)."""
    if isinstance(spec, dict):
        return {k: numpy_params(spec[k], rng, k) for k in sorted(spec)}
    shape = spec.shape[1:] if spec.logical[0] == "layers" else spec.shape
    fan_in = int(np.prod(shape[:-1])) if name == "wo" else shape[0]
    if name == "embedding":
        fan_in = shape[1]
    std = 0.1 if spec.init == "zeros" else 1 / np.sqrt(fan_in)
    return (rng.standard_normal(spec.shape) * std).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def model(request):
    """(variant, numpy weights, port weights)."""
    jcfg, _ = configs(request.param)
    w = numpy_params(jtf.abstract_params(jcfg), np.random.default_rng(31))
    return request.param, w, params_from_numpy(w, device="cpu")


def t(x):
    return torch.from_numpy(np.array(x))


def prompts(variant, n, p, seed=1):
    _, cfg = configs(variant)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n, p)).astype(np.int32)


def patches(cfg, b, s, seed=2):
    """Patch embeddings [B, min(frontend_tokens, S), d_model] for a VLM, of
    the scale of the token embeddings; None for another family."""
    if cfg.family != "vlm":
        return None
    p = min(cfg.frontend_tokens, s)
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, p, cfg.d_model)) / np.sqrt(cfg.d_model)).astype(
        np.float32)


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k], prefix + (k,))]
    if isinstance(tree, tuple) and not hasattr(tree, "shape"):
        return [x for i, v in enumerate(tree) for x in flat(v, prefix + (i,))]
    return [(prefix, tuple(tree.shape), tuple(tree.logical), tree.init,
             str(tree.dtype))]


def _jax_padded(cache, max_len):
    def pad(x):
        return jnp.pad(x, [(0, 0)] * 3 + [(0, max_len - x.shape[3])]
                       + [(0, 0)] * (x.ndim - 4))
    return {key: tuple(pad(x) for x in leaves) for key, leaves in cache.items()}


def _assert_cache(ours, ref):
    assert sorted(ours) == sorted(ref)
    for key in ref:
        for a, b in zip(ours[key], ref[key]):
            if a.dtype == torch.int8:   # one quantum, in a few values at most
                d = np.abs(a.numpy().astype(np.int32) - np.asarray(b).astype(np.int32))
                assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).sum())
            else:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ["internvl2-1b", "deepseek-67b"])
def test_config_and_specs_match_jax(arch):
    """Field for field, less the JAX-only knobs and the port's
    ``embed_scale``; parameter and cache trees equal the JAX package's,
    full and reduced, bfloat16 and int8."""
    j, p = jax_get_config(arch), get_config(arch)
    assert {k: v for k, v in vars(p).items() if k != "embed_scale"} == \
        {k: v for k, v in vars(j).items() if k not in DROPPED}
    for jc, pc in ((j, p), (j.reduced(), p.reduced())):
        assert flat(transformer.abstract_params(pc)) == flat(jtf.abstract_params(jc))
        for cd in ("", "int8"):
            pcc, jcc = (dataclasses.replace(c, cache_dtype=cd) for c in (pc, jc))
            assert flat(transformer.abstract_cache(pcc, 3, 64)) == \
                flat(jtf.abstract_cache(jcc, 3, 64))


def test_deepseek_67b_is_served_at_38_layers_and_full_width():
    """The one-card profile keeps every width and 38 of 95 layers:
    27,976,638,464 parameters, 55.95 GB in bfloat16, and 152 KiB of bfloat16
    cache a token.  The other archs serve whole."""
    full, cut = get_config("deepseek-67b"), port_config("deepseek-67b")
    assert cut == dataclasses.replace(full, num_layers=38)
    assert llm_config("deepseek-67b", "port") == cut
    assert llm_config("deepseek-67b", "small").num_layers == 2
    n = registry.count_params(cut)
    assert n == 27_976_638_464 and 55.9e9 < 2 * n < 56.0e9
    layer = (registry.count_params(full) - n) // (95 - 38)
    assert 2 * layer == 1_384_153_088
    kv = transformer.abstract_cache(cut, 1, 1)["layers"][0]
    assert 2 * np.prod(kv.shape) * 2 == 152 * 1024
    for arch in ("internvl2-1b", "deepseek-moe-16b", "granite-moe-3b-a800m"):
        assert llm_config(arch, "port") == get_config(arch)


def test_decode_inbox_holds_a_slot_batch_of_internvl2_messages():
    """The decode instance takes one inbox entry per segment, so a burst
    of prefilled requests waits in its ring: at internvl2-1b's widths (13.2
    MB a message at max_len 1024, prefilled faster than a segment decodes)
    a ring of 4 messages dropped one of 8 requests on the card.  Eight
    slots get room for 11."""
    full = get_config("internvl2-1b")
    big = largest_message_bytes(full, 1024)
    cache = 24 * 2 * 2 * 1024 * 64 * 2
    assert cache + 4 * full.vocab_padded < big < cache + 4 * full.vocab_padded + 2 ** 17
    assert ring_bytes_for(full, 1024) == 4 * big
    assert ring_bytes_for(full, 1024, max_slots=8) == 11 * big
    _, cfg = configs("internvl2")
    engine = ServingEngine(cfg, params=params_from_numpy(numpy_params(
        jtf.abstract_params(configs("internvl2")[0]), np.random.default_rng(3)),
        device="cpu"), max_len=MAX_LEN, device="cpu")
    ws, _ = build_llm_disagg_set(engine, name="vlm_rings", max_slots=8)
    assert ws.instances["vlm_rings.decode0"].inbox.buf_size == \
        ring_bytes_for(cfg, MAX_LEN, max_slots=8)


# -------------------------------------------------------------- model
@pytest.mark.parametrize("plen", [9, 20])
@pytest.mark.parametrize("cache_dtype", ["", "int8"])
def test_prefill_and_decode_logits_match_jax(model, cache_dtype, plen):
    """Prefill logits and cache with patch embeddings over the first
    min(16, S) positions (a VLM; none for deepseek-67b), then three decode
    steps (a lockstep index, then per-row positions twice) without any,
    each step's logits and cache."""
    variant, weights, port_weights = model
    jcfg, cfg = configs(variant, cache_dtype)
    toks = prompts(variant, 2, plen, seed=12)
    pe = patches(cfg, 2, plen)
    batch = {"tokens": jnp.asarray(toks)}
    if pe is not None:
        batch["patch_embeds"] = jnp.asarray(pe)
    jlogits, jcache = jtf.prefill(weights, batch, jcfg)
    logits, cache = transformer.prefill(
        port_weights, t(toks), cfg, max_len=MAX_LEN,
        patch_embeds=None if pe is None else t(pe))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    if pe is not None:   # the patches change the logits
        assert not np.allclose(logits.numpy(), transformer.prefill(
            port_weights, t(toks), cfg)[0].numpy(), **TOL)
    jcache = _jax_padded(jcache, MAX_LEN)
    _assert_cache(cache, jcache)
    for cur in (plen, [plen + 1, 4], [plen + 2, 5]):
        jcur = jnp.int32(cur) if isinstance(cur, int) else jnp.asarray(cur, jnp.int32)
        pcur = cur if isinstance(cur, int) else torch.tensor(cur, dtype=torch.int32)
        nxt = prompts(variant, 2, 1, seed=13 + len(str(cur)))[:, 0]
        jlogits, jcache = jtf.decode_step(
            weights, jcache, {"tokens": jnp.asarray(nxt), "cur_index": jcur}, jcfg)
        logits = transformer.decode_step(port_weights, cache, t(nxt), pcur, cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **(INT8_LOGIT_TOL if cache_dtype else TOL))
        _assert_cache(cache, jcache)


def test_greedy_tokens_identical_to_jax(model):
    """Text only, engine against engine (the JAX engine passes only
    tokens); and with patch embeddings, the port's ``generate`` against the
    JAX package's prefill and greedy decode steps."""
    variant, weights, port_weights = model
    jcfg, cfg = configs(variant)
    toks = prompts(variant, 2, 18, seed=14)
    ours = ServingEngine(cfg, params=port_weights, max_len=MAX_LEN, device="cpu")
    ref = JaxEngine(jcfg, params=weights, max_len=MAX_LEN).generate(toks, steps=8)
    np.testing.assert_array_equal(ours.generate(toks, steps=8).tokens, ref.tokens)
    pe = patches(cfg, 2, 18)
    if pe is None:
        return
    jlogits, jcache = jtf.prefill(weights, {"tokens": jnp.asarray(toks),
                                            "patch_embeds": jnp.asarray(pe)}, jcfg)
    jcache = _jax_padded(jcache, MAX_LEN)
    out = [toks]
    for i in range(8):
        tok = np.asarray(jnp.argmax(jlogits, axis=-1)).astype(np.int32)
        out.append(tok[:, None])
        jlogits, jcache = jtf.decode_step(
            weights, jcache, {"tokens": jnp.asarray(tok), "cur_index": jnp.int32(18 + i)},
            jcfg)
    np.testing.assert_array_equal(ours.generate(toks, steps=8, patch_embeds=pe).tokens,
                                  np.concatenate(out, axis=1))


def test_patch_embeds_that_do_not_fit_raise():
    _, cfg = configs("internvl2")
    w = params_from_numpy(numpy_params(jtf.abstract_params(configs("internvl2")[0]),
                                       np.random.default_rng(3)), device="cpu")
    toks = t(prompts("internvl2", 1, 6))
    with pytest.raises(ValueError, match="do not fit"):
        transformer.prefill(w, toks, cfg, patch_embeds=torch.zeros(1, 7, cfg.d_model))
    dense = dataclasses.replace(cfg, family="dense")
    with pytest.raises(ValueError, match="vlm"):
        transformer.prefill(w, toks, dense, patch_embeds=torch.zeros(1, 6, cfg.d_model))


@pytest.mark.parametrize("cache_dtype", ["", "int8"])
def test_internvl2_g7_serves_tokens_equal_to_solo_generate(cache_dtype):
    """internvl2 at groups of 7, text only as the JAX engine serves it:
    four requests, greedy and sampled, through two slots of the port's
    llm_disagg set; nothing dropped, every stream equal to its solo
    ``generate``."""
    jcfg, cfg = configs("internvl2 g7", cache_dtype)
    w = params_from_numpy(numpy_params(jtf.abstract_params(jcfg),
                                       np.random.default_rng(32)), device="cpu")
    engine = ServingEngine(cfg, params=w, max_len=MAX_LEN, device="cpu")
    ws, dec = build_llm_disagg_set(engine, name=f"vlm{cache_dtype}", max_slots=2,
                                   segment_len=3)
    reqs = [{"prompt": prompts("internvl2 g7", 1, 3 + 4 * i, seed=40 + i), "steps": 6,
             "temperature": 0.7 * (i % 2), "seed": 300 + i} for i in range(4)]
    with ws:
        p = ws.proxies[0]
        res = [p.wait_result(u, timeout_s=60)
               for u in [p.submit(APP_LLM_DISAGG, r) for r in reqs]]
        stats = ws.transport_stats()
    check_served(engine, reqs, res)
    assert stats.dropped == 0 and ws.dead_uids() == set()
    assert dec.stats["completed"] == 4

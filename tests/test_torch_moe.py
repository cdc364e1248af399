"""The port's MoE layers held against the JAX package on the CPU: the float32
router, the capacity dispatch with dropped assignments, the dropless path
with and without shared experts, and the reduced deepseek-moe-16b (one
dense layer, then one MoE layer with a shared expert) and
granite-moe-3b-a800m (stock, and at the full model's 24 query heads over 8:
groups of 3) through prefill, decode, ``generate`` and the port's
``llm_disagg`` Workflow Set.  Also the parameter counts of the four
configurations this slice brings, against the reference's.

Weights and inputs are made with numpy from a seed and fed to both
frameworks; the port gets the weights through ``params_from_numpy``.  The
JAX side runs as its own tests run it on the CPU: the model through its
plain reference branches, ``moe_ffn`` through its single-device branch (no
partitioner).  Tolerances: float32 2e-5 (docs/kernels.md); greedy tokens
identical.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import get_config, port_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch.serve import check_served
from repro_torch.models import moe, registry, transformer
from repro_torch.serving import APP_LLM_DISAGG, ServingEngine, build_llm_disagg_set
from repro_torch.serving.disagg import largest_message_bytes

#: Small shapes gain nothing from many intra-op threads; the suite's other
#: workers (some timing-sensitive) share the machine's cores.
torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-5)
MAX_LEN = 32
DROPPED = {"use_pallas", "decode_unroll", "attn_causal_skip"}

#: The reduced MoE configs: deepseek-moe-16b keeps 1 dense and 1 MoE layer,
#: 4 experts, top-2 and 1 shared expert; granite-moe-3b-a800m 2 MoE layers,
#: 4 experts, top-2, no shared expert, and 4 query heads over 1 (groups of
#: 4); "granite g3" has the full model's 24 query heads over 8.
VARIANTS = {
    "deepseek-moe": ("deepseek-moe-16b", {}),
    "granite": ("granite-moe-3b-a800m", {}),
    "granite g3": ("granite-moe-3b-a800m", dict(num_heads=24, num_kv_heads=8)),
}


def configs(variant, cache_dtype=""):
    """(JAX config, port config): the variant's reduced config in float32."""
    arch, kw = VARIANTS[variant]
    kw = dict(kw, dtype="float32", cache_dtype=cache_dtype)
    return (dataclasses.replace(jax_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def numpy_params(spec, rng, name=""):
    """Normal with std 1/sqrt(fan_in) over the contracted axes (not the
    layer axis, and for the experts' [E, in, out] leaves not the expert
    axis), so that activations stay O(1) and 2e-5 measures float32
    rounding; the embedding 1/sqrt(d_model); 0.1 for the norm scales (zeros
    in the spec)."""
    if isinstance(spec, dict):
        return {k: numpy_params(spec[k], rng, k) for k in sorted(spec)}
    shape = spec.shape[1:] if spec.logical[0] == "layers" else spec.shape
    fan_in = int(np.prod(shape[:-1])) if name == "wo" else shape[0]
    if name.startswith("we_"):
        fan_in = shape[-2]
    if name == "embedding":
        fan_in = shape[1]
    std = 0.1 if spec.init == "zeros" else 1 / np.sqrt(fan_in)
    return (rng.standard_normal(spec.shape) * std).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def model(request):
    """(variant, numpy weights, port weights)."""
    jcfg, _ = configs(request.param)
    w = numpy_params(jtf.abstract_params(jcfg), np.random.default_rng(21))
    return request.param, w, params_from_numpy(w, device="cpu")


def t(x):
    return torch.from_numpy(np.array(x))


def prompts(variant, n, p, seed=1):
    _, cfg = configs(variant)
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n, p)).astype(np.int32)


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k], prefix + (k,))]
    if isinstance(tree, tuple) and not hasattr(tree, "shape"):
        return [x for i, v in enumerate(tree) for x in flat(v, prefix + (i,))]
    return [(prefix, tuple(tree.shape), tuple(tree.logical), tree.init,
             str(tree.dtype))]


def _jax_padded(cache, max_len):
    """The JAX prefill cache padded to the decode layout, every leaf."""
    def pad(x):
        return jnp.pad(x, [(0, 0)] * 3 + [(0, max_len - x.shape[3])]
                       + [(0, 0)] * (x.ndim - 4))
    return {key: tuple(pad(x) for x in leaves) for key, leaves in cache.items()}


def _assert_cache(ours, ref):
    assert sorted(ours) == sorted(ref)
    for key in ref:
        for a, b in zip(ours[key], ref[key]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "granite-moe-3b-a800m"])
def test_moe_config_and_specs_match_jax(arch):
    """Field for field, less the JAX-only knobs and the port's
    ``embed_scale``; the parameter and cache trees (with the ``dense0``
    leaves of deepseek-moe's leading dense layer) equal the JAX package's,
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
    if p.first_dense_layers:
        cache = transformer.abstract_cache(p, 1, 8)
        assert list(cache) == ["dense0", "layers"]
        assert cache["dense0"][0].shape[0] == 1 and cache["layers"][0].shape[0] == 27
        slots = transformer.layer_slots(p)
        assert slots[0] == ("dense0", (0,), 0) and slots[1] == ("layers", (0,), 0)
        assert len(slots) == 28


#: (arch, parameters, active parameters a token), as the JAX package's
#: registry counts them
COUNTS = [
    ("deepseek-moe-16b", 16_377_694_208, 2_830_616_576),
    ("granite-moe-3b-a800m", 3_375_072_768, 959_153_664),
    ("internvl2-1b", 629_910_400, 629_910_400),
    ("deepseek-67b", 67_425_001_472, 67_425_001_472),
]


@pytest.mark.parametrize("arch,n,active", COUNTS)
def test_count_params_match_jax(arch, n, active):
    j, p = jax_get_config(arch), get_config(arch)
    assert registry.count_params(p) == jregistry.count_params(j) == n
    assert registry.count_active_params(p) == jregistry.count_active_params(j) == active
    assert port_config(arch).num_layers == (38 if arch == "deepseek-67b"
                                            else p.num_layers)


# ------------------------------------------------------------- router
def _layer(variant, weights):
    """The variant's first MoE layer: (numpy leaves, port tensors)."""
    lp = {k: v[0] for k, v in weights["layers"].items()}
    return lp, {k: t(v) for k, v in lp.items()}


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def test_router_matches_jax(model):
    variant, weights, _ = model
    jcfg, cfg = configs(variant)
    lp, tlp = _layer(variant, weights)
    x = _x(3, 2, 9, cfg.d_model)
    w, i, aux = moe._router(t(x), tlp, cfg)
    jw, ji, jaux = jmoe._router(jnp.asarray(x), lp, jcfg)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


def test_router_ties_break_to_the_lower_expert_as_jax():
    """A zero router gives every expert the same probability: the top k
    are experts 0..k-1, as ``jax.lax.top_k`` picks them."""
    jcfg, cfg = configs("deepseek-moe")
    lp = {"router": np.zeros((cfg.d_model, cfg.num_experts), np.float32)}
    x = _x(4, 1, 5, cfg.d_model)
    w, i, aux = moe._router(t(x), {"router": t(lp["router"])}, cfg)
    jw, ji, jaux = jmoe._router(jnp.asarray(x), lp, jcfg)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert (i.numpy() == np.arange(cfg.top_k)).all()
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


# ---------------------------------------------------------------- FFN
def test_moe_ffn_with_dropped_assignments_matches_jax(model):
    """24 tokens, top-2 of 4 experts: 48 assignments against a capacity of
    16 an expert.  The tokens lean toward expert 0 (its router column added
    to each), which gets more than 16 and drops the rest; output and aux
    equal the JAX package's single-device branch."""
    variant, weights, _ = model
    jcfg, cfg = configs(variant)
    lp, tlp = _layer(variant, weights)
    r0 = lp["router"][:, 0]
    x = _x(5, 2, 12, cfg.d_model) + 4 * r0 / np.linalg.norm(r0)
    _, top_i, _ = moe._router(t(x), tlp, cfg)
    cap = moe._capacity(24, cfg)
    assert cap == jmoe._capacity(24, jcfg) == 16
    per_expert = np.bincount(top_i.numpy().reshape(-1), minlength=cfg.num_experts)
    assert (per_expert > cap).any(), per_expert
    out, aux = moe.moe_ffn(t(x), tlp, cfg)
    jout, jaux = jmoe.moe_ffn(jnp.asarray(x), lp, jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    # a dropped assignment is missing from its token's output
    dropless, _ = moe.moe_ffn_dense_fallback(t(x), tlp, cfg)
    assert not np.allclose(out.numpy(), dropless.numpy(), **TOL)


@pytest.mark.parametrize("shared", [True, False])
def test_dense_fallback_matches_jax(shared):
    jcfg, cfg = configs("deepseek-moe")
    if not shared:
        jcfg, cfg = (dataclasses.replace(c, num_shared_experts=0) for c in (jcfg, cfg))
    weights = numpy_params(jtf.abstract_params(jcfg), np.random.default_rng(22))
    lp, tlp = _layer("deepseek-moe", weights)
    assert ("ws_gate" in lp) == shared
    x = _x(6, 2, 7, cfg.d_model)
    out, aux = moe.moe_ffn_dense_fallback(t(x), tlp, cfg)
    jout, jaux = jmoe.moe_ffn_dense_fallback(jnp.asarray(x), lp, jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


def test_dense_fallback_rows_do_not_depend_on_the_batch(model):
    """A token's dropless output is the same whatever the other rows: the
    first b rows of a batch of 8 equal a batch of b, bit for bit (every
    product runs on rows padded to ``ROW_BLOCK``)."""
    variant, weights, _ = model
    _, cfg = configs(variant)
    _, tlp = _layer(variant, weights)
    x = t(_x(7, 8, 1, cfg.d_model))
    full, _ = moe.moe_ffn_dense_fallback(x, tlp, cfg)
    for b in (1, 2, 5):
        assert torch.equal(moe.moe_ffn_dense_fallback(x[:b], tlp, cfg)[0], full[:b]), b


# -------------------------------------------------------------- model
def test_dense0_weights_carry_across(model):
    variant, weights, port_weights = model
    _, cfg = configs(variant)
    assert set(port_weights) == set(weights)
    assert len(port_weights["layers"]) == cfg.num_layers - cfg.first_dense_layers
    if cfg.first_dense_layers:
        assert len(port_weights["dense0"]) == 1
        for name, stacked in weights["dense0"].items():
            np.testing.assert_array_equal(port_weights["dense0"][0][name].numpy(),
                                          stacked[0])


@pytest.mark.parametrize("dropless", [False, True])
def test_prefill_and_decode_logits_match_jax(model, dropless):
    """Prefill logits and cache (``dense0`` too), then three decode steps (a
    lockstep index, then per-row positions twice), each step's logits and
    cache, through ``moe_ffn`` or the dropless path."""
    variant, weights, port_weights = model
    jcfg, cfg = configs(variant)
    toks = prompts(variant, 2, 9, seed=12)
    jlogits, jcache = jtf.prefill(weights, {"tokens": jnp.asarray(toks)}, jcfg,
                                  dropless=dropless)
    logits, cache = transformer.prefill(port_weights, t(toks), cfg, max_len=MAX_LEN,
                                        dropless=dropless)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    jcache = _jax_padded(jcache, MAX_LEN)
    _assert_cache(cache, jcache)
    for cur in (9, [10, 4], [11, 5]):
        jcur = jnp.int32(cur) if isinstance(cur, int) else jnp.asarray(cur, jnp.int32)
        pcur = cur if isinstance(cur, int) else torch.tensor(cur, dtype=torch.int32)
        nxt = prompts(variant, 2, 1, seed=13 + len(str(cur)))[:, 0]
        jlogits, jcache = jtf.decode_step(
            weights, jcache, {"tokens": jnp.asarray(nxt), "cur_index": jcur}, jcfg,
            dropless=dropless)
        logits = transformer.decode_step(port_weights, cache, t(nxt), pcur, cfg,
                                         dropless=dropless)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        _assert_cache(cache, jcache)


def test_greedy_tokens_identical_to_jax(model):
    """Both engines serve dropless: the same greedy tokens."""
    variant, weights, port_weights = model
    jcfg, cfg = configs(variant)
    toks = prompts(variant, 2, 6, seed=14)
    ref = JaxEngine(jcfg, params=weights, max_len=MAX_LEN).generate(toks, steps=8)
    ours = ServingEngine(cfg, params=port_weights, max_len=MAX_LEN,
                         device="cpu").generate(toks, steps=8)
    np.testing.assert_array_equal(ours.tokens, ref.tokens)


def test_serves_tokens_equal_to_solo_generate(model):
    """Four requests, greedy and sampled, through two slots of the port's
    llm_disagg set: deepseek-moe's requests ship their ``dense0`` and
    ``layers`` leaves as pages, which unflatten into the slot cache's
    leaves; nothing dropped, every stream equal to its solo ``generate``."""
    variant, _, port_weights = model
    _, cfg = configs(variant)
    engine = ServingEngine(cfg, params=port_weights, max_len=MAX_LEN, device="cpu")
    leaves = ["dense0", "layers"] if cfg.first_dense_layers else ["layers"]
    assert sorted(engine.batch_axes) == leaves
    per_layer = 2 * cfg.resolved_kv_heads * MAX_LEN * cfg.resolved_head_dim * 4
    assert largest_message_bytes(cfg, MAX_LEN) > cfg.num_layers * per_layer
    ws, dec = build_llm_disagg_set(engine, name=variant.replace(" ", "_"),
                                   max_slots=2, segment_len=3)
    reqs = [{"prompt": prompts(variant, 1, 3 + 4 * i, seed=40 + i), "steps": 6,
             "temperature": 0.7 * (i % 2), "seed": 200 + i} for i in range(4)]
    with ws:
        p = ws.proxies[0]
        res = [p.wait_result(u, timeout_s=60)
               for u in [p.submit(APP_LLM_DISAGG, r) for r in reqs]]
        stats = ws.transport_stats()
    check_served(engine, reqs, res)
    assert stats.dropped == 0 and ws.dead_uids() == set()
    assert dec.stats["completed"] == 4 and stats.kv_pages >= 4

"""The port's Mamba2 layers and the Zamba2 hybrid (zamba2-1.2b, the hybrid
family) held against the JAX package on the CPU: the SSD recurrence (scan
and step), the causal conv, the softplus, a Mamba2 layer in both modes (a
2-token prompt too), and the reduced float32 zamba2 (d_model 256, 8 SSM
heads of 64, state 16) at 5 layers with the shared block after every 2, so
that two places of the shared block and one tail layer run, through
prefill, decode (a lockstep index and per-row positions), greedy tokens,
``generate`` against ``generate_reference`` and the port's ``llm_disagg``
Workflow Set.  Also the parameter count at full width and the decode
message of one request.

Weights and inputs are made with numpy from a seed and fed to both
frameworks; the port gets the weights through ``params_from_numpy``.  The
JAX side runs as its own tests run it on the CPU (its ``ssd_scan`` is plain
jnp; the shared block's attention through its reference branches).
Tolerances: float32 2e-5 (docs/kernels.md), the SSD state 1e-4 as the WKV6
state's (tests/test_kernels.py); greedy tokens identical.  Tokens at
temperature > 0 follow the port's own RNG contract and are held against
the port's own paths.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import mamba2 as jm
from repro.models import registry as jregistry
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import ARCH_IDS, get_config, port_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.launch.serve import check_served
from repro_torch.models import mamba2, registry, transformer
from repro_torch.serving import APP_LLM_DISAGG, ServingEngine, build_llm_disagg_set
from repro_torch.serving.disagg import largest_message_bytes, ring_bytes_for

#: Small shapes gain nothing from many intra-op threads; the suite's other
#: workers (some timing-sensitive) share the machine's cores.
torch.set_num_threads(2)

ARCH = "zamba2-1.2b"
TOL = dict(atol=2e-5, rtol=2e-5)
STATE_TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN = 32
DROPPED = {"use_pallas", "decode_unroll", "attn_causal_skip"}


def configs():
    """(JAX config, port config): the reduced config in float32 at 5 layers
    with the shared block after every 2 (2 periods and a tail layer), as
    tests/test_serving_engine.py runs it."""
    kw = dict(dtype="float32", num_layers=5, hybrid_attn_every=2)
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def numpy_params(spec, rng, name=""):
    """Normal with std 1/sqrt(fan_in) over the contracted axes (not the
    layer axis), so that activations stay O(1) and 2e-5 measures float32
    rounding; the embedding 1/sqrt(d_model); 0.1 for the norm scales and
    the conv bias (zeros in the spec), the conv taps 0.5; dt_bias and
    a_log 0.5 x N(0, 1) (zeros in the spec) so that the decays spread; the
    skip D as the spec (ones)."""
    if isinstance(spec, dict):
        return {k: numpy_params(spec[k], rng, k) for k in sorted(spec)}
    shape = spec.shape[1:] if spec.logical[0] == "layers" else spec.shape
    if spec.init == "ones":
        return np.ones(spec.shape, np.float32)
    fan_in = int(np.prod(shape[:-1])) if name == "wo" else shape[0]
    if name == "embedding":
        fan_in = shape[1]
    std = {"dt_bias": 0.5, "a_log": 0.5, "conv_w": 0.5}.get(
        name, 0.1 if spec.init == "zeros" else 1 / np.sqrt(fan_in))
    return (rng.standard_normal(spec.shape) * std).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    return numpy_params(jm.abstract_params(configs()[0]), np.random.default_rng(41))


@pytest.fixture(scope="module")
def port_weights(weights):
    return params_from_numpy(weights, device="cpu")


def t(x):
    return torch.from_numpy(np.array(x))


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
    """The JAX prefill cache in the decode layout: the shared block's KV
    padded to ``max_len`` positions, the Mamba2 states as they are."""
    pad = [(0, 0)] * 3
    return {"mamba": cache["mamba"],
            "attn": tuple(jnp.pad(x, pad + [(0, max_len - x.shape[3]), (0, 0)])
                          for x in cache["attn"])}


def _assert_cache(ours, ref):
    assert sorted(ours) == ["attn", "mamba"]
    conv, ssd = ours["mamba"]
    np.testing.assert_allclose(conv.numpy(), np.asarray(ref["mamba"][0]), **TOL)
    np.testing.assert_allclose(ssd.numpy(), np.asarray(ref["mamba"][1]), **STATE_TOL)
    for a, b in zip(ours["attn"], ref["attn"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# ------------------------------------------------------------ configs
def test_config_and_specs_match_jax():
    """Field for field, less the JAX-only knobs and the port's
    ``embed_scale``; the parameter and cache trees (the shared block's specs
    without a layer axis) equal the JAX package's at full width, reduced,
    and at 5 layers; the registry routes the family here."""
    j, p = jax_get_config(ARCH), get_config(ARCH)
    assert ARCH in ARCH_IDS
    assert {k: v for k, v in vars(p).items() if k != "embed_scale"} == \
        {k: v for k, v in vars(j).items() if k not in DROPPED}
    for jc, pc in ((j, p), (j.reduced(), p.reduced()), configs()):
        assert flat(mamba2.abstract_params(pc)) == flat(jm.abstract_params(jc))
        for s in (1, 1024):
            assert flat(mamba2.abstract_cache(pc, 3, s)) == flat(jm.abstract_cache(jc, 3, s))
        assert mamba2._periods(pc) == jm._periods(jc)
        assert mamba2._dims(pc) == jm._dims(jc)
    assert mamba2._periods(p) == (6, 6, 2) and mamba2._periods(configs()[1]) == (2, 2, 1)
    assert registry.module_for(p) is mamba2
    with pytest.raises(NotImplementedError, match="registry"):
        transformer.abstract_params(p)


def test_count_params_at_full_width_and_depth():
    j, p = jax_get_config(ARCH), port_config(ARCH)
    assert (p.num_layers, p.d_model, p.d_inner, p.hybrid_attn_every) == (38, 2048, 4096, 6)
    assert mamba2._dims(p) == (4096, 64, 4224, 8384)
    assert registry.count_params(p) == jregistry.count_params(j) == 1_170_473_856


def test_weights_carry_across(weights, port_weights):
    """The stacked Mamba2 ``layers`` become per-layer views; the shared
    block, which has no layer axis, stays whole."""
    _, cfg = configs()
    assert len(port_weights["layers"]) == cfg.num_layers
    for name, stacked in weights["layers"].items():
        for i, lp in enumerate(port_weights["layers"]):
            np.testing.assert_array_equal(lp[name].numpy(), stacked[i])
    assert set(port_weights["shared"]) == set(weights["shared"])
    for name, w in weights["shared"].items():
        np.testing.assert_array_equal(port_weights["shared"][name].numpy(), w)


def test_a_decode_message_is_the_states_and_the_shared_kv():
    """One request's decode message at full width and ``max_len`` 1024:
    0.96 MB of conv state, 39.85 MB of SSD state and 50.33 MB of the shared
    block's KV (6 places), beside the logits row."""
    cfg = port_config(ARCH)
    conv, ssd = 38 * 4224 * 3 * 2, 38 * 64 * 64 * 64 * 4
    kv = 6 * 2 * 32 * 1024 * 64 * 2
    assert (conv, ssd, kv) == (963_072, 39_845_888, 50_331_648)
    big = largest_message_bytes(cfg, 1024)
    assert big - (conv + ssd + kv) == 65_536 + 4 * 32_000 + 12 * 1024
    assert ring_bytes_for(cfg, 1024, max_slots=8) == 11 * big


# --------------------------------------------------------------- core
def _ssd_inputs(seed, b, tt, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, tt, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, tt, h)))).astype(np.float32)
    a = np.exp(-dt * np.exp(rng.standard_normal(h) * 0.5)).astype(np.float32)
    bm, cm = (rng.standard_normal((b, tt, n)).astype(np.float32) for _ in range(2))
    s0 = (rng.standard_normal((b, h, p, n)) * 0.5).astype(np.float32)
    return x, dt, a, bm, cm, s0


@pytest.mark.parametrize("tt,chunk", [(1, 256), (37, 8), (64, 16), (300, 256)])
def test_ssd_scan_matches_jax(tt, chunk):
    """The chunked form (chunks of ``SSD_CHUNK``, one at T <= 64) against
    the JAX step scan, whose chunk divides T only after halving (37 over 8
    runs chunks of 1; 300 over 256 chunks of 4)."""
    xs = _ssd_inputs(tt, 2, tt, 3, 8, 5)
    y, s = mamba2.ssd_scan(*map(t, xs))
    jy, js = jm.ssd_scan(*map(jnp.asarray, xs), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **STATE_TOL)


def test_ssd_step_matches_jax_and_continues_the_scan():
    xs = _ssd_inputs(3, 2, 6, 3, 8, 5)
    x, dt, a, bm, cm, s0 = xs
    y, s = mamba2.ssd_step(*(t(v[:, 0]) for v in (x, dt, a, bm, cm)), t(s0))
    jy, js = jm.ssd_step(*(jnp.asarray(v[:, 0]) for v in (x, dt, a, bm, cm)),
                         jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **STATE_TOL)
    # split where a chunk ends, the scan goes on from its state bit for bit
    whole, sw = mamba2.ssd_scan(*map(t, xs), chunk=2)
    head, sh = mamba2.ssd_scan(*(t(v[:, :4]) for v in xs[:5]), t(s0), chunk=2)
    tail, st = mamba2.ssd_scan(*(t(v[:, 4:]) for v in xs[:5]), sh, chunk=2)
    assert torch.equal(torch.cat([head, tail], dim=1), whole) and torch.equal(st, sw)


def _decays(kind, xs):
    """``_ssd_inputs`` with its decays set: ``spread`` as drawn,
    ``zero_decays`` every seventh position at dt 200 (a = 0 in float32),
    ``near_one`` dt 1e-4 (a ~ 1 - 1e-4: the state keeps every input)."""
    x, dt, a, bm, cm, s0 = xs
    dt = dt.copy()
    if kind == "zero_decays":
        dt[:, ::7] = 200.0
    elif kind == "near_one":
        dt = np.full_like(dt, 1e-4)
    a = np.exp(-dt * np.exp(np.random.default_rng(0).standard_normal(dt.shape[-1]) * 0.5))
    return x, dt, a.astype(np.float32), bm, cm, s0


@pytest.mark.parametrize("tt,kind", [(256, "spread"), (200, "spread"),
                                     (300, "zero_decays"), (300, "near_one")])
def test_chunked_ssd_scan_matches_jax(tt, kind):
    """The chunked form (chunks of ``SSD_CHUNK``; 200 and 300 end in a
    partial chunk) against the JAX step scan: 4 whole chunks, a ragged last
    one, decays of exactly 0 (the log-decay -inf, no NaN), decays near 1."""
    xs = _decays(kind, _ssd_inputs(tt + 1, 2, tt, 3, 8, 5))
    if kind == "zero_decays":
        assert (xs[2] == 0).sum() > 100
    assert -(-tt // mamba2.SSD_CHUNK) > 1
    y, s = mamba2.ssd_scan(*map(t, xs))
    jy, js = jm.ssd_scan(*map(jnp.asarray, xs))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **STATE_TOL)


@pytest.mark.parametrize("tt", [37, 150])
def test_chunked_ssd_scan_gradient_matches_jax(tt):
    """``ssd_scan_log``'s gradient (of x, dt, the log-decays, B, C and the
    start state) against ``jax.grad`` of the JAX scan of exp(la), with a
    fifth of the log-decays at -200 (the decays 0): finite, within 2e-5."""
    x, dt, a, bm, cm, s0 = _ssd_inputs(tt, 2, tt, 3, 8, 5)
    la = np.log(a)
    la[:, ::5] = -200.0
    rng = np.random.default_rng(tt)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    gs = rng.standard_normal(s0.shape).astype(np.float32)
    args = (x, dt, la, bm, cm, s0)

    def jloss(*v):
        y, s = jm.ssd_scan(v[0], v[1], jnp.exp(v[2]), *v[3:])
        return jnp.sum(y * gy) + jnp.sum(s * gs)

    jgrads = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    leaves = [t(v).requires_grad_() for v in args]
    y, s = mamba2.ssd_scan_log(*leaves)
    ((y * t(gy)).sum() + (s * t(gs)).sum()).backward()
    for leaf, jg in zip(leaves, jgrads):
        assert torch.isfinite(leaf.grad).all()
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(jg), **TOL)


def test_mamba_layer_gradient_matches_jax_with_decays_underflowing(weights, port_weights):
    """A training layer (``train=True``: the chunked form from the
    log-decays) differentiated against ``jax.grad`` of the JAX layer, with
    two heads' a_log at 5 so that exp(a_log) dt passes ~103 and their decays
    underflow to 0 in float32: every gradient finite, each leaf within 2e-5
    of its largest element.  (Elementwise, a leaf such as conv_w sums 300
    positions' terms of up to ~100 into entries of ~1e-3: there both
    float32 gradients, the JAX one and this, lie ~1e-4 from the float64
    one, so no float32 order meets 2e-5 of the entry itself.)"""
    jcfg, cfg = configs()
    _, n_heads, conv_dim, _ = mamba2._dims(cfg)
    lp = {k: v[1].copy() for k, v in weights["layers"].items()}
    lp["a_log"][:2] = 5.0
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 150, cfg.d_model)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    zero = (np.zeros((2, conv_dim, mamba2.CONV_WIDTH - 1), np.float32),
            np.zeros((2, n_heads, cfg.ssm_head_dim, cfg.ssm_state), np.float32))
    dtv = np.asarray(jax.nn.softplus(
        jnp.asarray(x @ lp["w_in"])[..., -n_heads:] + lp["dt_bias"]))
    assert (np.exp(-np.exp(lp["a_log"]) * dtv) == 0).sum() > 100

    def jloss(xj, lpj):
        out = jm.mamba_layer(xj, lpj, jcfg, tuple(map(jnp.asarray, zero)), True)[0]
        return jnp.sum(out * g)

    jgx, jglp = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in lp.items()})
    xt = t(x).requires_grad_()
    plp = {k: t(v).requires_grad_() for k, v in lp.items()}
    out = mamba2.mamba_layer(xt, plp, cfg, tuple(map(t, zero)), True, train=True)[0]
    (out * t(g)).sum().backward()
    for name, got, want in [("x", xt.grad, jgx)] + [(k, plp[k].grad, jglp[k])
                                                     for k in sorted(lp)]:
        assert torch.isfinite(got).all(), name
        want = np.asarray(want)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 2e-5 * float(np.abs(want).max()) + 2e-5, (name, err)


def test_ssd_scan_ops_grow_with_chunks_not_positions():
    """The local ops ``ssd_scan`` dispatches (``LocalCounter``, as the
    dry-run counts them): a constant set-up and two a chunk (the carried
    state's scale and add), so 4,096 positions take ~150, not ~5 a
    position as the step loop took."""
    from repro_torch.launch.hlo_analysis import analyze

    def ops(tt):
        xs = _ssd_inputs(1, 1, tt, 2, 4, 4)
        return analyze(lambda *v: mamba2.ssd_scan(*v)[0].sum(), *map(t, xs))["n_ops"]

    n1, n2, n4 = ops(1024), ops(2048), ops(4096)
    chunks = 4096 // mamba2.SSD_CHUNK
    assert (n4 - n2, n2 - n1) == (2 * (chunks // 2), 2 * (chunks // 4))
    assert n4 < 3 * chunks < 4096 // 8


@pytest.mark.parametrize("tt", [1, 2, 3, 11])
def test_causal_conv_matches_jax(tt):
    rng = np.random.default_rng(tt)
    x = rng.standard_normal((2, tt, 12)).astype(np.float32)
    w = rng.standard_normal((12, mamba2.CONV_WIDTH)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    np.testing.assert_allclose(mamba2._causal_conv_seq(t(x), t(w), t(b)).numpy(),
                               np.asarray(jm._causal_conv_seq(*map(jnp.asarray, (x, w, b)))),
                               **TOL)


def test_softplus_is_jax_softplus_at_every_x():
    """``jax.nn.softplus`` is logaddexp(x, 0): log1p(exp(x)) where it is
    small, and above ``F.softplus``'s threshold of 20 not exactly x."""
    x = np.concatenate([np.linspace(-100, 100, 4001), [-1e30, 1e30, 0.0, 20.0, 20.5]]
                       ).astype(np.float32)
    np.testing.assert_allclose(mamba2._softplus(t(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("seq_mode,tt", [(True, 9), (True, 2), (False, 1)])
def test_mamba_layer_matches_jax(weights, port_weights, seq_mode, tt):
    """One layer from a nonzero conv and SSD state: a 9-token and a 2-token
    sequence (the 2-token one keeps the old state's last input beside its
    two raw inputs) and one decode step: output, new conv state, new SSD
    state."""
    jcfg, cfg = configs()
    _, n_heads, conv_dim, _ = mamba2._dims(cfg)
    rng = np.random.default_rng(tt)
    x = rng.standard_normal((2, tt, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((2, conv_dim, mamba2.CONV_WIDTH - 1)).astype(np.float32)
    ssd = (rng.standard_normal((2, n_heads, cfg.ssm_head_dim, cfg.ssm_state))
           * 0.5).astype(np.float32)
    jlp = {k: jnp.asarray(v[1]) for k, v in weights["layers"].items()}
    jout, (jconv, jssd) = jm.mamba_layer(jnp.asarray(x), jlp, jcfg,
                                         (jnp.asarray(conv), jnp.asarray(ssd)), seq_mode)
    out, (nconv, nssd) = mamba2.mamba_layer(t(x), port_weights["layers"][1], cfg,
                                            (t(conv), t(ssd)), seq_mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(nconv.numpy(), np.asarray(jconv), **TOL)
    np.testing.assert_allclose(nssd.numpy(), np.asarray(jssd), **STATE_TOL)
    if seq_mode and tt == 2:   # the old state's last column, then the new inputs
        np.testing.assert_array_equal(nconv[..., 0].numpy(), conv[..., -1])


# -------------------------------------------------------------- model
@pytest.mark.parametrize("plen", [2, 9])
def test_prefill_and_decode_match_jax(weights, port_weights, plen):
    """Prefill logits and cache (both Mamba2 states of every layer, the
    shared block's KV at its 2 places, padded to ``max_len``); then a
    lockstep decode step and two with per-row positions, each step's logits
    and cache.  The tail layer (5 = 2 x 2 + 1) runs after the last shared
    block."""
    jcfg, cfg = configs()
    toks = prompts(2, plen, seed=12 + plen)
    jlogits, jcache = jm.prefill(weights, {"tokens": jnp.asarray(toks)}, jcfg)
    logits, cache = mamba2.prefill(port_weights, t(toks), cfg, max_len=MAX_LEN)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    jcache = _jax_padded(jcache, MAX_LEN)
    _assert_cache(cache, jcache)
    assert cache["mamba"][0].shape[0] == 5 and cache["attn"][0].shape[0] == 2
    for cur in (plen, [plen + 1, plen + 4], [plen + 2, plen + 5]):
        jcur = jnp.int32(cur) if isinstance(cur, int) else jnp.asarray(cur, jnp.int32)
        pcur = cur if isinstance(cur, int) else torch.tensor(cur, dtype=torch.int32)
        nxt = prompts(2, 1, seed=13 + len(str(cur)))[:, 0]
        jlogits, jcache = jm.decode_step(
            weights, jcache, {"tokens": jnp.asarray(nxt), "cur_index": jcur}, jcfg)
        logits = mamba2.decode_step(port_weights, cache, t(nxt), pcur, cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        _assert_cache(cache, jcache)


# ------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def engine(port_weights):
    return ServingEngine(configs()[1], params=port_weights, max_len=MAX_LEN,
                         device="cpu")


def test_greedy_tokens_identical_to_jax(weights, engine):
    jcfg, _ = configs()
    toks = prompts(2, 5, seed=14)
    ref = JaxEngine(jcfg, params=weights, max_len=MAX_LEN).generate(toks, steps=8)
    np.testing.assert_array_equal(engine.generate(toks, steps=8).tokens, ref.tokens)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_equals_generate_reference(engine, temperature):
    toks = prompts(3, 6, seed=15)
    fast = engine.generate(toks, steps=7, temperature=temperature, seed=4)
    slow = engine.generate_reference(toks, steps=7, temperature=temperature, seed=4)
    np.testing.assert_array_equal(fast.tokens, slow.tokens)


def test_serves_tokens_equal_to_solo_generate(engine):
    """Four requests, greedy and sampled, 2 and 3-11 token prompts, through
    two slots of the port's llm_disagg set: the pages unflatten in sorted
    key order (``attn`` before ``mamba``) into the slot cache's leaves;
    nothing dropped, every stream equal to its solo ``generate``."""
    assert sorted(engine.batch_axes) == ["attn", "mamba"]
    assert engine.batch_axes == {"attn": (1, 1), "mamba": (1, 1)}
    ws, dec = build_llm_disagg_set(engine, name="zamba2", max_slots=2, segment_len=3)
    reqs = [{"prompt": prompts(1, 2 + 3 * i, seed=40 + i), "steps": 6,
             "temperature": 0.7 * (i % 2), "seed": 200 + i} for i in range(4)]
    with ws:
        p = ws.proxies[0]
        res = [p.wait_result(u, timeout_s=60)
               for u in [p.submit(APP_LLM_DISAGG, r) for r in reqs]]
        stats = ws.transport_stats()
    check_served(engine, reqs, res)
    assert stats.dropped == 0 and ws.dead_uids() == set()
    assert dec.stats["completed"] == 4 and stats.kv_pages >= 4


def test_an_int8_cache_is_refused(monkeypatch, capsys):
    with pytest.raises(ValueError, match="hybrid"):
        dataclasses.replace(get_config(ARCH), cache_dtype="int8")
    monkeypatch.setattr("sys.argv", ["serve", "--workflow", "llm", "--llm-arch", ARCH,
                                     "--profile", "small", "--device", "cpu",
                                     "--cache-dtype", "int8"])
    with pytest.raises(SystemExit) as e:
        launcher.main()
    assert e.value.code == 2
    assert "no int8 layout" in capsys.readouterr().err


def test_launcher_serves_zamba2_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["serve", "--workflow", "llm", "--llm-arch", ARCH,
                                     "--profile", "small", "--device", "cpu",
                                     "--requests", "3", "--llm-steps", "5"])
    assert launcher.main() == 0
    out = capsys.readouterr().out
    assert "3/3 requests" in out and "dropped=0" in out
    assert "served tokens equal the engine's solo generate" in out

"""The port's rwkv6 slice held against the JAX package on the CPU, on the
reduced float32 rwkv6-7b config (2 layers, d_model 256, 8 heads of 32).

Weights and inputs are made with numpy from a seed and fed to both
frameworks; the port gets the weights through ``params_from_numpy``.  The
JAX side runs as its own tests run it on the CPU: the Pallas WKV6 kernel in
interpret mode where a test names it (and in the model with
``use_pallas="on"`` at a prompt length its kernel takes), its reference scan
otherwise.  Tolerances: the WKV6 output 2e-5 and its state 1e-4
(``tests/test_kernels.py``'s WKV6 tests), the model float32 2e-5, greedy
tokens identical.  Tokens at temperature > 0 follow the port's own RNG
contract and are held against the port's own paths.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.rwkv6_wkv import wkv6 as jax_wkv6
from repro.kernels.rwkv6_wkv.ref import wkv6_ref as jax_wkv6_ref
from repro.models import rwkv6 as jrw
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import wkv6
from repro_torch.kernels.rwkv6_wkv import wkv6_ref
from repro_torch.launch import serve as launcher
from repro_torch.launch.serve import check_served
from repro_torch.models import layers as L
from repro_torch.models import registry, rwkv6, transformer
from repro_torch.serving import APP_LLM_DISAGG, ServingEngine, build_llm_disagg_set
from repro_torch.serving.disagg import largest_message_bytes, ring_bytes_for

#: Small shapes gain nothing from many intra-op threads; the suite's other
#: workers (some timing-sensitive) share the machine's cores.
torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-5)
STATE_TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN = 32


def configs(use_pallas="auto"):
    """(JAX config, port config): reduced rwkv6-7b in float32."""
    j = dataclasses.replace(jax_get_config("rwkv6-7b").reduced(), dtype="float32",
                            use_pallas=use_pallas)
    p = dataclasses.replace(get_config("rwkv6-7b").reduced(), dtype="float32")
    return j, p


#: fan-in of each leaf: the contracted axis (after the layer axis)
_FAN_IN_AXIS = {"lora_b": 1, "embedding": 1}


def numpy_params(spec, rng, name=""):
    """A numpy weight tree for a JAX ParamSpec tree: normal with std
    1/sqrt(fan_in) over the contracted axis, so that activations stay O(1)
    and 2e-5 measures float32 rounding; 0.1 for the leaves the spec
    zero-initializes (norm scales, token-shift mixes, the decay base w0 and
    the bonus u), so that each is exercised."""
    if isinstance(spec, dict):
        return {k: numpy_params(spec[k], rng, k) for k in sorted(spec)}
    shape = spec.shape[1:] if spec.logical[0] == "layers" else spec.shape
    fan_in = shape[_FAN_IN_AXIS.get(name, 0)] if len(shape) > 1 else 1
    std = 0.1 if spec.init == "zeros" else 1 / np.sqrt(fan_in)
    return (rng.standard_normal(spec.shape) * std).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = configs()
    return numpy_params(jrw.abstract_params(jcfg), np.random.default_rng(0))


@pytest.fixture(scope="module")
def port_weights(weights):
    return params_from_numpy(weights, device="cpu")


@pytest.fixture(scope="module")
def engine(port_weights):
    _, cfg = configs()
    return ServingEngine(cfg, params=port_weights, max_len=MAX_LEN, device="cpu")


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
    return [(prefix, tuple(tree.shape), tuple(tree.logical), tree.init, str(tree.dtype))]


# ------------------------------------------------------------- configs
def test_config_and_param_specs_match_jax():
    """Field for field, less the JAX-only knobs and the port's
    ``embed_scale`` (the JAX package's name rule); the reduced config is the
    JAX package's (2 layers, d_model 256, 8 heads of 32); specs of the
    weights and of the decode state equal the JAX package's."""
    dropped = {"use_pallas", "decode_unroll", "attn_causal_skip"}
    assert "rwkv6-7b" in ARCH_IDS
    for reduce in (False, True):
        j, p = jax_get_config("rwkv6-7b"), get_config("rwkv6-7b")
        if reduce:
            j, p = j.reduced(), p.reduced()
        assert {k: v for k, v in vars(p).items() if k != "embed_scale"} == \
            {k: v for k, v in vars(j).items() if k not in dropped}
        assert not p.embed_scale and not j.name.startswith("gemma")
        assert flat(rwkv6.abstract_params(p)) == flat(jrw.abstract_params(j))
        for s in (1, 64, 4096):
            assert flat(rwkv6.abstract_cache(p, 3, s)) == flat(jrw.abstract_cache(j, 3, s))
    red = get_config("rwkv6-7b").reduced()
    assert (red.num_layers, red.d_model, red.num_heads, red.resolved_head_dim) == \
        (2, 256, 8, 32)
    assert get_config("rwkv6-7b").source == "arXiv:2404.05892"
    assert get_config("rwkv6-7b").param_count() == 7_576_621_056


def test_registry_routes_ssm_to_rwkv6():
    _, cfg = configs()
    assert registry.module_for(cfg) is rwkv6
    assert registry.abstract_cache(cfg, 2, 8) == rwkv6.abstract_cache(cfg, 2, 8)
    with pytest.raises(NotImplementedError, match="registry"):
        transformer.abstract_params(cfg)


# ---------------------------------------------------------------- wkv6
def _wkv_inputs(seed, b, tt, h, kk, nonzero_state=True):
    """Drawn as tests/test_kernels.py draws them: w = sigmoid(.) 0.5 + 0.45,
    k x 0.3, u x 0.1; the initial state N(0, 0.5^2) or zero."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((b, tt, h, kk)).astype(np.float32)
    k = (rng.standard_normal((b, tt, h, kk)) * 0.3).astype(np.float32)
    v = rng.standard_normal((b, tt, h, kk)).astype(np.float32)
    w = (0.5 / (1 + np.exp(-rng.standard_normal((b, tt, h, kk)))) + 0.45).astype(np.float32)
    u = (rng.standard_normal((h, kk)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((b, h, kk, kk)) * 0.5 * nonzero_state).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("tt,kk", [(1, 32), (3, 32), (16, 32), (64, 32), (97, 32),
                                   (16, 64)])
def test_wkv6_plain_matches_pallas_interpret_and_oracle(tt, kk):
    xs = _wkv_inputs(tt, 2, tt, 2, kk)
    y, s = wkv6(*map(t, xs))
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    jy, js = jax_wkv6(*map(jnp.asarray, xs), block_t=tt, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **STATE_TOL)
    ry, rs = jax_wkv6_ref(*map(jnp.asarray, xs))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), **STATE_TOL)
    # the plain version is what the wrapper runs on the CPU
    y2, s2 = wkv6_ref(*map(t, xs))
    assert torch.equal(y, y2) and torch.equal(s, s2)


@pytest.mark.parametrize("tt,kk", [(97, 32), (70, 64)])
def test_wkv6_plain_matches_jax_oracle_at_model_decays(tt, kk):
    """The decays the model draws, w = exp(-exp(x)) rounded to bfloat16 for
    x over [-6, 4], with exact zeros and ones planted: the port's plain loop
    equals the JAX package's oracle there too, and w = 0 zeroes the state's
    row as the recurrence says."""
    rng = np.random.default_rng(tt + kk)
    r, k, v, _, u, s0 = _wkv_inputs(9, 2, tt, 3, kk)
    x = rng.uniform(-6, 4, r.shape).astype(np.float32)
    w = torch.from_numpy(np.exp(-np.exp(x))).bfloat16().float().numpy()
    pick = rng.random(r.shape)
    w[pick < 0.02] = 0.0
    w[pick > 0.98] = 1.0
    w[:, -1, 0, :] = 0.0   # the last step forgets head 0's state
    xs = (r, k, v, w, u, s0)
    y, s = wkv6(*map(t, xs))
    ry, rs = jax_wkv6_ref(*map(jnp.asarray, xs))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), **STATE_TOL)
    # the state's head 0 is the last step's k v^T alone
    np.testing.assert_allclose(s[:, 0].numpy(), np.einsum(
        "bk,bv->bkv", k[:, -1, 0], v[:, -1, 0]), **STATE_TOL)


def test_wkv6_continuation_equals_one_call():
    """Two calls with the state carried equal one call over the whole
    sequence (a prompt served in two pieces)."""
    r, k, v, w, u, s0 = map(t, _wkv_inputs(5, 1, 41, 2, 32))
    y, s = wkv6(r, k, v, w, u, s0)
    y1, s1 = wkv6(r[:, :17].contiguous(), k[:, :17].contiguous(),
                  v[:, :17].contiguous(), w[:, :17].contiguous(), u, s0)
    y2, s2 = wkv6(r[:, 17:].contiguous(), k[:, 17:].contiguous(),
                  v[:, 17:].contiguous(), w[:, 17:].contiguous(), u, s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y.numpy(), **TOL)
    np.testing.assert_allclose(s2.numpy(), s.numpy(), **STATE_TOL)


def test_wkv6_bfloat16_keeps_the_type_and_a_float32_state():
    xs = [t(x).to(torch.bfloat16) for x in _wkv_inputs(6, 1, 5, 2, 32)[:5]]
    y, s = wkv6(*xs, torch.zeros(1, 2, 32, 32))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32


def test_wkv6_refuses_shapes_that_do_not_fit():
    r, k, v, w, u, s0 = map(t, _wkv_inputs(7, 1, 4, 2, 32))
    with pytest.raises(ValueError, match="differ"):
        wkv6(r, k[:, :3], v, w, u, s0)
    with pytest.raises(ValueError, match="do not fit"):
        wkv6(r, k, v, w, u[:1], s0)
    with pytest.raises(ValueError, match="at least one"):
        wkv6(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u, s0)


def test_wkv6_step_matches_jax():
    r, k, v, w, u, s0 = _wkv_inputs(8, 3, 1, 2, 32)
    y, s = rwkv6.wkv6_step(*(t(x[:, 0]) for x in (r, k, v, w)), t(u), t(s0))
    jy, js = jrw.wkv6_step(*(jnp.asarray(x[:, 0]) for x in (r, k, v, w)),
                           jnp.asarray(u), jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **STATE_TOL)


# --------------------------------------------------------------- blocks
@pytest.mark.parametrize("seq_mode", [True, False])
def test_time_mix_and_channel_mix_match_jax(weights, port_weights, seq_mode):
    jcfg, cfg = configs()
    rng = np.random.default_rng(9)
    tt = 6 if seq_mode else 1
    x = rng.standard_normal((2, tt, cfg.d_model)).astype(np.float32)
    xp = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    h, kk = cfg.num_heads, cfg.resolved_head_dim
    st = (rng.standard_normal((2, h, kk, kk)) * 0.5).astype(np.float32)
    jlp = {n: jnp.asarray(a[1]) for n, a in weights["layers"].items()}
    lp = port_weights["layers"][1]

    out, nxp, nst = rwkv6._time_mix(t(x), lp, cfg, t(xp), t(st), seq_mode)
    jout, jnxp, jnst = jrw._time_mix(jnp.asarray(x), jlp, jcfg, jnp.asarray(xp),
                                     jnp.asarray(st), seq_mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(nxp.numpy(), np.asarray(jnxp), **TOL)
    np.testing.assert_allclose(nst.numpy(), np.asarray(jnst), **STATE_TOL)

    out, nxp = rwkv6._channel_mix(t(x), lp, cfg, t(xp), seq_mode)
    jout, jnxp = jrw._channel_mix(jnp.asarray(x), jlp, jcfg, jnp.asarray(xp), seq_mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(nxp.numpy(), np.asarray(jnxp), **TOL)


def test_row_mean_is_the_mean_at_any_row_count():
    from repro_torch.models.layers import MIN_REDUCE_ROWS, row_mean

    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (3, 2, 40)).astype(np.float32))
    for rows in (x[:1, :1], x[:1], x, x.reshape(1, 6, 40).expand(4, 6, 40)):
        assert rows.reshape(-1, 40).shape[0] != MIN_REDUCE_ROWS
        got = row_mean(rows)
        assert got.shape == rows.shape[:-1] + (1,)
        np.testing.assert_allclose(got.numpy(), rows.mean(-1, keepdim=True).numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_decode_projections_in_row_blocks_equal_the_plain_product():
    rng = np.random.default_rng(12)
    w = t(rng.standard_normal((40, 7)).astype(np.float32))
    for b in (1, 8, 16, 21, 40):
        x = t(rng.standard_normal((b, 1, 40)).astype(np.float32))
        got = L.row_blocks_matmul(x, w)
        assert got.shape == (b, 1, 7)
        np.testing.assert_allclose(got.numpy(), (x @ w).numpy(), rtol=1e-6, atol=1e-6)


def test_group_norm_matches_jax():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32) * 3
    w = (rng.standard_normal(64) * 0.1).astype(np.float32)
    np.testing.assert_allclose(rwkv6._group_norm(t(x), t(w), 4).numpy(),
                               np.asarray(jrw._group_norm(jnp.asarray(x), jnp.asarray(w), 4)),
                               **TOL)


# ---------------------------------------------------------------- model
def _check_cache(ours, ref):
    for o, r in zip(ours["rwkv"], ref["rwkv"]):
        assert tuple(o.shape) == tuple(r.shape)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **STATE_TOL)


@pytest.mark.parametrize("plen,use_pallas", [(8, "on"), (7, "auto")])
def test_prefill_and_decode_match_jax(weights, port_weights, plen, use_pallas):
    """A prompt of 8 tokens takes the JAX package's Pallas WKV6 (interpret
    mode), one of 7 its reference scan; the port runs its one path.  Then
    two decode steps: logits, and every leaf of the state written in place."""
    jcfg, cfg = configs(use_pallas)
    toks = prompts(2, plen)
    jlogits, jcache = jrw.prefill(weights, {"tokens": jnp.asarray(toks)}, jcfg)
    logits, cache = rwkv6.prefill(port_weights, t(toks), cfg, max_len=MAX_LEN)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    _check_cache(cache, jcache)
    for i in range(2):
        nxt = prompts(2, 1, seed=9 + i)[:, 0]
        jlogits, jcache = jrw.decode_step(
            weights, jcache, {"tokens": jnp.asarray(nxt),
                              "cur_index": jnp.int32(plen + i)}, jcfg)
        logits = rwkv6.decode_step(port_weights, cache, t(nxt), plen + i, cfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        _check_cache(cache, jcache)


def test_prefill_state_does_not_grow_with_the_prompt(port_weights):
    _, cfg = configs()
    shapes = [[tuple(x.shape) for x in rwkv6.prefill(port_weights, t(prompts(1, n)),
                                                      cfg)[1]["rwkv"]]
              for n in (3, 20)]
    assert shapes[0] == shapes[1]
    with pytest.raises(ValueError, match="max_len"):
        rwkv6.prefill(port_weights, t(prompts(1, 9)), cfg, max_len=8)


def test_generate_greedy_tokens_identical_to_jax(weights, engine):
    jcfg, _ = configs()
    toks = prompts(2, 5, seed=2)
    ref = JaxEngine(jcfg, params=weights, max_len=MAX_LEN).generate(toks, steps=8)
    ours = engine.generate(toks, steps=8)
    np.testing.assert_array_equal(ours.tokens, ref.tokens)


# ---------------------------------------------------------- RNG contract
def test_slot_decode_matches_solo_generate_at_temperature(engine):
    """At temperature 0.7: slot decode (any slot, any segment length, other
    requests resident) gives the solo ``generate``'s tokens."""
    toks = prompts(2, 5, seed=7)
    steps, seed = 9, 11
    solo = engine.generate(toks[:1], steps=steps, temperature=0.7, seed=seed).tokens
    ref = engine.generate_reference(toks[:1], steps=steps, temperature=0.7, seed=seed)
    np.testing.assert_array_equal(solo, ref.tokens)
    logits, cache = engine.prefill(toks[:1])
    other_logits, other = engine.prefill(toks[1:])
    for slot, seg in ((2, 3), (0, 4)):
        state = engine.init_slots(4)
        state = engine.insert_slot(state, slot, cache, logits[0], start=5,
                                   seed=seed, steps=steps, temperature=0.7)
        state = engine.insert_slot(state, 3 - slot, other, other_logits[0], start=5,
                                   seed=seed + 1, steps=steps, temperature=0.0)
        got = []
        while len(got) < steps:
            state, out, adv = engine.decode_segment(state, seg)
            got.extend(int(x) for x in out[adv[:, slot], slot])
        np.testing.assert_array_equal(np.concatenate([toks[0], got[:steps]]), solo[0])


# -------------------------------------------------------- disaggregation
def test_disagg_serves_tokens_equal_to_solo_generate(engine):
    """Two-stage prefill -> decode over the port's fabric, four requests of
    different prompt lengths through two slots, greedy and sampled: nothing
    dropped, every result equal to a solo ``generate``, and every message
    the same size whatever the prompt length.  How many requests are
    resident at once depends on how fast the prefills arrive, so only the
    bound is held here; two resident requests are held to their solo
    tokens in ``test_slot_decode_matches_solo_generate_at_temperature``."""
    ws, dec = build_llm_disagg_set(engine, name="rwkv", max_slots=2, segment_len=3)
    reqs = [{"prompt": prompts(1, 3 + 5 * i, seed=20 + i), "steps": 6,
             "temperature": 0.7 * (i % 2), "seed": 100 + i} for i in range(4)]
    with ws:
        p = ws.proxies[0]
        uids = [p.submit(APP_LLM_DISAGG, r) for r in reqs]
        res = [p.wait_result(u, timeout_s=60) for u in uids]
        stats = ws.transport_stats()
    check_served(engine, reqs, res)
    assert stats.dropped == 0 and ws.dead_uids() == set()
    assert dec.stats["completed"] == 4 and 1 <= dec.stats["max_resident"] <= 2
    cfg = engine.cfg
    state_bytes = cfg.num_layers * (2 * cfg.d_model + cfg.num_heads
                                    * cfg.resolved_head_dim ** 2) * 4
    assert stats.kv_pages == 4
    assert stats.kv_bytes == 4 * (state_bytes + 4 * cfg.vocab_padded)


def test_decode_inbox_holds_a_full_state_message(engine):
    """At rwkv6-7b's widths the state is 34.08 MB at any ``max_len``, over
    twice the JAX package's 16 MiB ring: the decode inbox holds four."""
    full = get_config("rwkv6-7b")
    state = 32 * 2 * 4096 * 2 + 32 * 64 * 64 * 64 * 4
    assert state == 34_078_720
    for max_len in (1024, 4096):
        big = largest_message_bytes(full, max_len)
        assert state + 4 * full.vocab_padded < big < state + 4 * full.vocab_padded + 2 ** 17
        assert ring_bytes_for(full, max_len) == 4 * big
    ws, _ = build_llm_disagg_set(engine, name="rings")
    sizes = {n: i.inbox.buf_size for n, i in ws.instances.items()}
    assert sizes["rings.decode0"] >= 4 * largest_message_bytes(engine.cfg, MAX_LEN)


# --------------------------------------------------------------- launcher
def test_launcher_refuses_an_int8_cache_for_rwkv6(monkeypatch, capsys):
    with pytest.raises(ValueError, match="attention-free"):
        launcher.llm_config("rwkv6-7b", "small", "int8")
    assert launcher.llm_config("rwkv6-7b", "small").dtype == "float32"
    monkeypatch.setattr("sys.argv", ["serve", "--workflow", "llm", "--llm-arch",
                                     "rwkv6-7b", "--profile", "small", "--device",
                                     "cpu", "--cache-dtype", "int8"])
    with pytest.raises(SystemExit) as e:
        launcher.main()
    assert e.value.code == 2
    assert "attention-free" in capsys.readouterr().err


def test_launcher_serves_rwkv6_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["serve", "--workflow", "llm", "--llm-arch",
                                     "rwkv6-7b", "--profile", "small", "--device",
                                     "cpu", "--requests", "3", "--llm-steps", "5"])
    assert launcher.main() == 0
    out = capsys.readouterr().out
    assert "3/3 requests" in out and "recurrent state" in out
    assert "served tokens equal the engine's solo generate" in out

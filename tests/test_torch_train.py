"""The port's training path held against the JAX package on the CPU: the
plain flash-attention backward against ``jax.vjp`` of the reference's
plain attention, the chunked cross entropy and its gradient, one loss and
gradient of ``registry.loss_fn`` for every family (dense qwen3, chatglm3 and
gemma3 with local and global layers, moe granite with the capacity dispatch
and dropless, deepseek-moe dropless with its dense layer and shared expert, vlm
internvl2 with patch embeddings, ssm rwkv6, hybrid zamba2, audio whisper
with frames), ``vae_loss`` and ``diffusion_loss`` with the reference's noise
passed in, ``adamw_update`` with clipping, one ``make_train_step`` step and
two microbatches against one, the data pipeline's tokens, a checkpoint
saved by the JAX package loaded by the port, and the launcher lowering the
cross entropy on the CPU.

Weights and inputs are made with numpy from a seed and fed to both
frameworks as float32; the port's training tree is the JAX layout
(``convert.tensors_from_numpy``), viewed per layer by ``to_port_layout``.
The JAX side runs as its own training runs on the CPU, through its plain
attention (its kernels are forward-only).  Tolerances: a loss to float32
2e-5 relative (docs/kernels.md); each gradient leaf max|a - b| <= 1e-4
max|b| + 1e-6, since a gradient sums many float32 products in another
order in each framework.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.wan_i2v import SMALL as JAX_SMALL
from repro.models import layers as jlayers
from repro.models import registry as jregistry
from repro.models.aigc import dit as jdit
from repro.models.aigc import vae as jvae
from repro.training import adamw_init as jadamw_init
from repro.training import make_train_step as jmake_train_step
from repro.training.checkpoint import save_checkpoint as jsave_checkpoint
from repro.training.data import data_iterator as jdata_iterator
from repro.training.optimizer import adamw_update as jadamw_update
from repro_torch.configs import get_config
from repro_torch.configs.wan_i2v import SMALL
from repro_torch.convert import tensors_from_numpy, to_port_layout
from repro_torch.kernels.flash_attention import (
    attention_bwd_ref, attention_ref, flash_attention, flash_attention_backward,
    flash_attention_with_lse)
from repro_torch.launch import train as launcher
from repro_torch.models import layers, registry
from repro_torch.models.aigc import dit, vae
from repro_torch.models.param import tree_leaves
from repro_torch.training import adamw_init, adamw_update, make_train_step
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.training.data import data_iterator
from repro_torch.training.train_step import trainable

#: Small shapes gain nothing from many intra-op threads; the suite's other
#: workers (some timing-sensitive) share the machine's cores.
torch.set_num_threads(2)

LOSS_RTOL = 2e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def numpy_params(spec, rng, name=""):
    """Normal with std 1/sqrt(fan_in) over the contracted axes (not a
    stacked leaf's layer axis, not the experts' axis), so that activations
    stay O(1): the embedding 1/sqrt(d_model), rwkv6's LoRA up-projection
    over its rank, an output projection [h, hd, d] and an HWIO convolution
    over all but their last axis; 0.1 for the leaves the spec zero-inits
    (norm scales, token-shift mixes, decay bases, biases), 0.006 for the
    "small" ones, the spec's ones (Mamba2's skip) kept; Mamba2's dt bias,
    A log and conv taps 0.5 so that the decays spread."""
    if isinstance(spec, dict):
        return {k: numpy_params(spec[k], rng, k) for k in sorted(spec)}
    shape = spec.shape[1:] if spec.logical[0] == "layers" else spec.shape
    if spec.init == "ones":
        return np.ones(spec.shape, np.float32)
    if name.endswith("wo") or len(shape) == 4:
        fan_in = int(np.prod(shape[:-1]))
    elif name.startswith("we_"):
        fan_in = shape[-2]
    elif name in ("embedding", "lora_b"):
        fan_in = shape[1]
    else:
        fan_in = shape[0]
    std = {"dt_bias": 0.5, "a_log": 0.5, "conv_w": 0.5}.get(
        name, {"small": 0.006, "zeros": 0.1}.get(spec.init, 1 / np.sqrt(fan_in)))
    return (rng.standard_normal(spec.shape) * std).astype(np.float32)


def paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def assert_grads(ours, ref, names):
    """Each leaf: max|a - b| <= GRAD_RTOL max|b| + GRAD_ATOL."""
    assert len(ours) == len(ref) == len(names)
    for name, a, b in zip(names, ours, ref):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape, name
        err, lim = float(np.abs(a - b).max()), GRAD_RTOL * float(np.abs(b).max()) + GRAD_ATOL
        assert err <= lim, f"{name}: max|a-b| {err:.3g} > {lim:.3g}"


def assert_loss(ours, ref):
    ours = float(ours.detach()) if isinstance(ours, torch.Tensor) else float(ours)
    ref = float(ref)
    assert abs(ours - ref) <= LOSS_RTOL * abs(ref) + 1e-7, (ours, ref)


def port_grads(loss_of, w):
    """(loss, metrics, grads in the JAX layout) of the port on weights w."""
    leaves = trainable(tensors_from_numpy(w, device="cpu"))
    loss, metrics = loss_of(to_port_layout(leaves))
    grads = torch.autograd.grad(loss, tree_leaves(leaves), allow_unused=True)
    return loss, metrics, [np.zeros(p.shape, np.float32) if g is None else g.numpy()
                           for g, p in zip(grads, tree_leaves(leaves))]


# ------------------------------------------------------- attention backward
ATTN_CASES = {
    # b, sq, sk, h, kv, d, causal
    "causal": (2, 40, 40, 4, 4, 32, True),
    "noncausal_sq_ne_sk": (1, 24, 70, 2, 2, 64, False),
    "gqa": (1, 33, 33, 6, 2, 32, True),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_bwd_ref_matches_jax_grad(case):
    b, sq, sk, h, kv, d, causal = ATTN_CASES[case]
    rng = np.random.default_rng(3)
    q, do = (rng.standard_normal((b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, sk, kv, d)).astype(np.float32) for _ in range(2))
    _, vjp = jax.vjp(lambda q_, k_, v_: jlayers.attention_full(
        q_, k_, v_, causal=causal, use_pallas="off"), *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    ours = attention_bwd_ref(tq, tk, tv, attention_ref(tq, tk, tv, causal=causal), tdo,
                             causal=causal)
    assert_grads([x.numpy() for x in ours], ref, ["dq", "dk", "dv"])
    # the wrapper's CPU gradient is this function, and autograd of the
    # forward's plain version agrees with it
    qq, kk, vv = (x.clone().requires_grad_() for x in (tq, tk, tv))
    through = torch.autograd.grad(flash_attention(qq, kk, vv, causal=causal), (qq, kk, vv), tdo)
    for a, r in zip(through, ours):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    qq, kk, vv = (x.clone().requires_grad_() for x in (tq, tk, tv))
    auto = torch.autograd.grad(attention_ref(qq, kk, vv, causal=causal), (qq, kk, vv), tdo)
    assert_grads([x.numpy() for x in ours], [x.numpy() for x in auto], ["dq", "dk", "dv"])


def _attn_inputs(case):
    b, sq, sk, h, kv, d, causal = ATTN_CASES[case]
    rng = np.random.default_rng(3)
    q, do = (rng.standard_normal((b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, sk, kv, d)).astype(np.float32) for _ in range(2))
    return q, k, v, do, causal


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_ref_lse_matches_jax_logsumexp(case):
    """The log-sum-exp ``attention_ref`` returns (what the bfloat16 forward
    kernel stores) against ``jax.nn.logsumexp`` of the reference attention's
    scaled, masked scores, formed as ``attention_full`` forms them; the
    output is unchanged by asking for it."""
    q, k, v, _, causal = _attn_inputs(case)
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qg = jnp.asarray(q).reshape(b, sq, kv, h // kv, d) * (d ** -0.5)
    scores = jnp.einsum("bsngd,btnd->bngst", qg, jnp.asarray(k)).astype(jnp.float32)
    if causal:
        mask = jnp.arange(sq)[:, None] >= jnp.arange(sk)[None, :]
        scores = jnp.where(mask[None, None, None], scores, jlayers.NEG_INF)
    ref = np.asarray(jax.nn.logsumexp(scores, axis=-1)).reshape(b, h, sq)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = attention_ref(tq, tk, tv, causal=causal, return_lse=True)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), ref, rtol=2e-5, atol=2e-5)
    assert torch.equal(o, attention_ref(tq, tk, tv, causal=causal))
    o2, lse2 = flash_attention_with_lse(tq, tk, tv, causal=causal)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


def test_flash_attention_with_lse_refuses_a_gradient():
    """``flash_attention_with_lse`` works outside autograd: under grad mode an
    input that needs a gradient is refused (as on the card, where the kernel
    fills o through ctypes with no ``grad_fn``); without grad it answers."""
    q, k, v, _, causal = _attn_inputs(sorted(ATTN_CASES)[0])
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with pytest.raises(RuntimeError, match="no backward kernel"):
        flash_attention_with_lse(tq, tk, tv, causal=causal)
    with torch.no_grad():
        o, lse = flash_attention_with_lse(tq, tk, tv, causal=causal)
    assert o.grad_fn is None and lse.grad_fn is None


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_bwd_ref_from_the_forwards_lse_matches_jax_grad(case):
    """``attention_bwd_ref`` given the forward's log-sum-exp (P = exp(s -
    lse), as the bfloat16 backward kernel takes it) against ``jax.vjp`` of
    the reference's plain attention, and against its own recompute; the
    wrapper's CPU path with ``lse`` is this function."""
    q, k, v, do, causal = _attn_inputs(case)
    _, vjp = jax.vjp(lambda q_, k_, v_: jlayers.attention_full(
        q_, k_, v_, causal=causal, use_pallas="off"), *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = attention_ref(tq, tk, tv, causal=causal, return_lse=True)
    ours = attention_bwd_ref(tq, tk, tv, o, tdo, causal=causal, lse=lse)
    assert_grads([x.numpy() for x in ours], ref, ["dq", "dk", "dv"])
    recomputed = attention_bwd_ref(tq, tk, tv, o, tdo, causal=causal)
    for a, r in zip(ours, recomputed):
        torch.testing.assert_close(a, r, rtol=2e-5, atol=2e-6)
    through = flash_attention_backward(tq, tk, tv, o, tdo, causal=causal, lse=lse)
    for a, r in zip(through, ours):
        assert torch.equal(a, r)


# ------------------------------------------------------------ cross entropy
def test_chunked_cross_entropy_and_gradient_match_jax():
    rng = np.random.default_rng(4)
    b, s, d, v = 2, 48, 16, 40       # chunk 32 -> 16: halved until it divides S
    hid = rng.standard_normal((b, s, d)).astype(np.float32)
    emb = (rng.standard_normal((d, v)) / 4).astype(np.float32)
    lab = rng.integers(0, v, (b, s)).astype(np.int32)
    ref, (gh, ge) = jax.value_and_grad(
        lambda h, e: jlayers.chunked_cross_entropy(h, e, jnp.asarray(lab), chunk=32),
        argnums=(0, 1))(jnp.asarray(hid), jnp.asarray(emb))
    th, te = (torch.from_numpy(x).requires_grad_() for x in (hid, emb))
    ours = layers.chunked_cross_entropy(th, te, torch.from_numpy(lab), chunk=32)
    assert_loss(ours, ref)
    assert_grads([g.numpy() for g in torch.autograd.grad(ours, (th, te))], [gh, ge],
                 ["hidden", "unembed"])


# ------------------------------------------------------------ every family
#: name -> (arch, overrides of the reduced float32 config, dropless, batch
#: extras); S 16 tokens, B 2.  Reduced zamba2 is 2 Mamba2 layers and the
#: shared block after them (a tail layer would cost the JAX side 14 s of
#: compilation).  chatglm3 keeps its half-dim rotary and groups its 4 query
#: heads over 1; gemma3's 2 layers form one period of a local layer with a
#: window of 8 (shorter than S, so both layers mask) and a global one;
#: deepseek-moe runs dropless through its leading dense layer, then a MoE
#: layer with a shared expert; deepseek-67b groups its 8 query heads over 2.
FAMILIES = {
    "dense qwen3": ("qwen3-1.7b", {}, False, ()),
    "dense chatglm3 half rotary": ("chatglm3-6b", {}, False, ()),
    "dense deepseek-67b gqa": ("deepseek-67b", {}, False, ()),
    "dense gemma3 local and global": (
        "gemma3-27b", dict(local_global_pattern=(1, 1), sliding_window=8), False, ()),
    "moe deepseek dropless": ("deepseek-moe-16b", {}, True, ()),
    "moe granite capacity": ("granite-moe-3b-a800m", {}, False, ()),
    "moe granite dropless": ("granite-moe-3b-a800m", {}, True, ()),
    "vlm internvl2 patches": ("internvl2-1b", {}, False, ("patch_embeds",)),
    "ssm rwkv6": ("rwkv6-7b", {}, False, ()),
    "hybrid zamba2": ("zamba2-1.2b", {}, False, ()),
    "audio whisper frames": ("whisper-large-v3", {}, False, ("frames",)),
}
B, S = 2, 16


def family_configs(arch, over):
    kw = dict(over, dtype="float32")
    return (dataclasses.replace(jax_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def family_batch(cfg, extras, rng):
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if "patch_embeds" in extras:
        batch["patch_embeds"] = rng.standard_normal(
            (B, min(cfg.frontend_tokens, S), cfg.d_model)).astype(np.float32)
    if "frames" in extras:
        batch["frames"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_loss_fn_and_gradient_match_jax(name):
    arch, over, dropless, extras = FAMILIES[name]
    jcfg, pcfg = family_configs(arch, over)
    rng = np.random.default_rng(5)
    w = numpy_params(jregistry.abstract_params(jcfg), rng)
    batch = family_batch(pcfg, extras, rng)
    (ref, rm), rg = jax.value_and_grad(
        lambda p: jregistry.loss_fn(p, {k: jnp.asarray(v) for k, v in batch.items()},
                                    jcfg, dropless=dropless), has_aux=True)(
        jax.tree.map(jnp.asarray, w))
    loss, metrics, grads = port_grads(
        lambda p: registry.loss_fn(p, _torch_batch(batch), pcfg, dropless=dropless), w)
    assert_loss(loss, ref)
    assert_loss(metrics["ce"], rm["ce"])
    if pcfg.num_experts:
        assert float(rm["aux"]) > 0
        assert_loss(metrics["aux"], rm["aux"])
    else:
        assert float(metrics["aux"]) == float(rm["aux"]) == 0.0
    assert_grads(grads, jax.tree.leaves(rg), paths(w))


# ----------------------------------------------------------------- Wan
def wan_weights(mod, seed):
    return numpy_params(mod.abstract_params(JAX_SMALL), np.random.default_rng(seed))


def test_vae_loss_matches_jax_with_its_noise():
    w = wan_weights(jvae, 6)
    rng = np.random.default_rng(7)
    frames = (rng.standard_normal((2, SMALL.image_size, SMALL.image_size, 3)) * 0.5
              ).astype(np.float32)
    key = jax.random.PRNGKey(8)
    (ref, rm), rg = jax.value_and_grad(
        lambda p: jvae.vae_loss(p, jnp.asarray(frames), JAX_SMALL, key), has_aux=True)(
        jax.tree.map(jnp.asarray, w))
    mu, _ = jvae.moments(jax.tree.map(jnp.asarray, w), jnp.asarray(frames), JAX_SMALL)
    noise = torch.from_numpy(np.array(jax.random.normal(key, mu.shape, mu.dtype)))
    loss, metrics, grads = port_grads(
        lambda p: vae.vae_loss(p, torch.from_numpy(frames), SMALL, noise=noise), w)
    assert_loss(loss, ref)
    assert_loss(metrics["rec"], rm["rec"])
    assert_loss(metrics["kl"], rm["kl"])
    assert_grads(grads, jax.tree.leaves(rg), paths(w))


def test_diffusion_loss_matches_jax_with_its_draws():
    w = wan_weights(jdit, 9)
    rng = np.random.default_rng(10)
    pd = SMALL.patch ** 2 * SMALL.vae_latent_ch
    z = rng.standard_normal((2, SMALL.video_tokens, pd)).astype(np.float32)
    text = rng.standard_normal((2, SMALL.text_len, SMALL.text_d_model)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref, rg = jax.value_and_grad(lambda p: jdit.diffusion_loss(
        p, jnp.asarray(z), jnp.asarray(text), JAX_SMALL, key))(jax.tree.map(jnp.asarray, w))
    rt, rn = jax.random.split(key)      # the reference's own draws
    t = torch.from_numpy(np.array(jax.random.randint(rt, (2,), 0, 1000)))
    noise = torch.from_numpy(np.array(jax.random.normal(rn, z.shape, jnp.float32)))
    loss, _, grads = port_grads(lambda p: (dit.diffusion_loss(
        p, torch.from_numpy(z), torch.from_numpy(text), SMALL, t=t, noise=noise), {}), w)
    assert_loss(loss, ref)
    assert_grads(grads, jax.tree.leaves(rg), paths(w))


# ------------------------------------------------------------- optimizer
@pytest.mark.parametrize("clip", [False, True])
def test_adamw_update_matches_jax(clip):
    rng = np.random.default_rng(12)
    w = {"a": rng.standard_normal((5, 7)).astype(np.float32),
         "b": {"c": rng.standard_normal((3,)).astype(np.float32)}}
    scale = 100.0 if clip else 1e-3        # global norm far above / below 1
    g = {"a": (rng.standard_normal((5, 7)) * scale).astype(np.float32),
         "b": {"c": (rng.standard_normal((3,)) * scale).astype(np.float32)}}
    jp, js = jax.tree.map(jnp.asarray, w), jadamw_init(jax.tree.map(jnp.asarray, w))
    p, s = tensors_from_numpy(w, "cpu"), adamw_init(tensors_from_numpy(w, "cpu"))
    for _ in range(3):       # the bias correction moves with the step
        jp, js, jn = jadamw_update(jax.tree.map(jnp.asarray, g), js, jp, lr=1e-2)
        p, s, n = adamw_update(tensors_from_numpy(g, "cpu"), s, p, lr=1e-2)
        assert (float(jn) > 1.0) == clip
        assert_loss(n, jn)
    assert s.step == int(js.step) == 3
    for tree, ref in ((p, jp), (s.mu, js.mu), (s.nu, js.nu)):
        for a, b in zip(tree_leaves(tree), jax.tree.leaves(ref)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6, atol=1e-7)


def whole_leaf_adamw(grads, mu, nu, params, gnorm, step, *, lr, b1=0.9, b2=0.95,
                     eps=1e-8, weight_decay=0.1, clip_norm=1.0):
    """The update as one expression per leaf over whole leaves, in place,
    clipped by the given norm: the arithmetic that ``adamw_update`` applies
    slice by slice."""
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step_f = torch.tensor(float(step), dtype=torch.float32)
    bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** step_f
    bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** step_f
    for g, m, v, p in zip(grads, mu, nu, params):
        g = g.float() * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        pf = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))


def optimizer_tree(dtype, rng):
    """Leaves against a slice of 7 elements: 36 (five slices and a ragged
    one), 14 (two whole slices), 3 (less than one) and a transposed [5, 6]
    view (not contiguous)."""
    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
    return {"ragged": t(4, 9), "whole": t(2, 7), "small": t(3), "strided": t(6, 5).t()}


@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_update_in_slices_equals_the_whole_leaf_update(monkeypatch, dtype, clip):
    from repro_torch.training import optimizer

    monkeypatch.setattr(optimizer, "SLICE", 7)
    rng = np.random.default_rng(13)
    params = optimizer_tree(dtype, rng)
    ref = [p.clone() for p in tree_leaves(params)]
    state = adamw_init(params)
    ref_mu = [m.clone() for m in tree_leaves(state.mu)]
    ref_nu = [v.clone() for v in tree_leaves(state.nu)]
    for step in range(1, 4):
        scale = 100.0 if clip else 1e-3        # global norm far above / below 1
        grads = {k: (v.float() * scale).to(dtype) for k, v in optimizer_tree(dtype, rng).items()}
        params, state, gnorm = adamw_update(grads, state, params, lr=1e-2)
        assert (float(gnorm) > 1.0) == clip
        whole_leaf_adamw(tree_leaves(grads), ref_mu, ref_nu, ref, gnorm, step, lr=1e-2)
        for tree, want in ((params, ref), (state.mu, ref_mu), (state.nu, ref_nu)):
            for a, b in zip(tree_leaves(tree), want):
                assert a.dtype == b.dtype and torch.equal(a, b)
    assert not params["strided"].is_contiguous()


@pytest.mark.parametrize("slice_elements", [7, None])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_global_norm_is_the_float64_norm_within_float32_rounding(monkeypatch, dtype,
                                                                 slice_elements):
    """Within the bound of a float32 sum of N squares added one by one:
    (N - 1) 2^-24 of the sum, half that of its root, plus one rounding of
    each square and of the root."""
    from repro_torch.training import optimizer

    if slice_elements:
        monkeypatch.setattr(optimizer, "SLICE", slice_elements)
    rng = np.random.default_rng(14)
    tree = optimizer_tree(dtype, rng)
    tree["big"] = torch.from_numpy(rng.standard_normal(1000).astype(np.float32)).to(dtype)
    leaves = tree_leaves(tree)
    exact = float(np.sqrt(sum(np.sum(np.square(x.double().numpy())) for x in leaves)))
    n = sum(x.numel() for x in leaves)
    ours = optimizer.global_norm(tree)
    assert ours.dtype == torch.float32
    assert abs(float(ours) - exact) <= (0.5 * (n - 1) + 2) * 2.0 ** -24 * exact


def test_adamw_keeps_the_parameter_type():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    s = adamw_init(p)
    p2, s2, _ = adamw_update({"w": torch.ones(4, dtype=torch.bfloat16)}, s, p, lr=0.1)
    assert p2["w"].dtype == torch.bfloat16 and s2.mu["w"].dtype == torch.float32
    assert float(p2["w"][0]) < 1.0


# ------------------------------------------------------------ train step
def qwen3_configs():
    return family_configs("qwen3-1.7b", {})


def test_train_step_matches_jax():
    """One step's new parameters, each leaf to max|a - b| <= 1e-4 max|b| +
    0.02 lr.  Adam's first step moves a weight by lr g / (|g| + eps): where
    |g| is near eps (1e-8), gradients that agree to 1e-4 of their leaf's
    largest give steps that differ by a share of lr (0.0048 lr at most
    here, in the embedding rows of tokens the batch does not hold)."""
    jcfg, pcfg = qwen3_configs()
    rng = np.random.default_rng(13)
    w = numpy_params(jregistry.abstract_params(jcfg), rng)
    batch = family_batch(pcfg, (), rng)
    jp = jax.tree.map(jnp.asarray, w)
    jp, _, jm = jmake_train_step(jcfg, lr=1e-3)(
        jp, jadamw_init(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    p = trainable(tensors_from_numpy(w, "cpu"))
    p, opt, m = make_train_step(pcfg, lr=1e-3)(p, adamw_init(p), _torch_batch(batch))
    assert opt.step == 1
    for key in ("loss", "ce", "grad_norm"):
        assert_loss(m[key], jm[key])
    for name, a, b in zip(paths(w), tree_leaves(p), jax.tree.leaves(jp)):
        a, b = a.detach().numpy(), np.asarray(b)
        err, lim = float(np.abs(a - b).max()), 1e-4 * float(np.abs(b).max()) + 0.02 * 1e-3
        assert err <= lim, f"{name}: max|a-b| {err:.3g} > {lim:.3g}"


def test_two_microbatches_match_one_batch():
    """tests/test_training.py's check on the port: the loss to 1e-4
    relative and the new parameters to 5e-4, its tolerances."""
    jcfg, pcfg = qwen3_configs()
    rng = np.random.default_rng(14)
    w = numpy_params(jregistry.abstract_params(jcfg), rng)
    batch = _torch_batch(family_batch(pcfg, (), rng))
    out = []
    for mb in (1, 2):
        p = trainable(tensors_from_numpy(w, "cpu"))
        out.append(make_train_step(pcfg, lr=1e-3, microbatches=mb)(p, adamw_init(p), batch))
    (p1, _, m1), (p2, _, m2) = out
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)
    assert max(float((a - b).detach().abs().max()) for a, b in
               zip(tree_leaves(p1), tree_leaves(p2))) < 5e-4


# ------------------------------------------------------- data, checkpoint
def test_data_iterator_gives_the_jax_packages_tokens():
    ours, ref = data_iterator(500, 3, 20, seed=7), jdata_iterator(500, 3, 20, seed=7)
    for _ in range(3):
        a, b = next(ours), next(ref)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])


def test_checkpoint_saved_by_jax_loads_into_the_port(tmp_path):
    jcfg, pcfg = family_configs("whisper-large-v3", {})   # two layer stacks
    w = numpy_params(jregistry.abstract_params(jcfg), np.random.default_rng(15))
    jp = jax.tree.map(jnp.asarray, w)
    js = jadamw_init(jp)
    js = js._replace(step=js.step + 5, mu=jax.tree.map(lambda x: x * 2, jp))
    path = str(tmp_path / "jax.npz")
    jsave_checkpoint(path, jp, js, step=42)
    p = tensors_from_numpy(jax.tree.map(np.zeros_like, w), "cpu")
    params, opt, step = load_checkpoint(path, p, adamw_init(p))
    assert step == 42 and opt.step == 5
    for a, b in zip(tree_leaves(params), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tree_leaves(opt.mu), jax.tree.leaves(js.mu)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # and what the port saves, the port loads back, bfloat16 leaves included
    p16 = {"x": torch.randn(3, 2).bfloat16(), "y": [torch.arange(4.0)]}
    save_checkpoint(str(tmp_path / "port.npz"), p16, adamw_init(p16), step=7)
    back, opt2, step2 = load_checkpoint(str(tmp_path / "port.npz"), p16, adamw_init(p16))
    assert step2 == 7 and opt2.step == 0 and back["x"].dtype == torch.bfloat16
    assert torch.equal(back["x"], p16["x"]) and torch.equal(back["y"][0], p16["y"][0])


# ------------------------------------------------------------------ launcher
def test_launcher_lowers_ce_on_the_cpu(capsys):
    """tests/test_training.py's short run (lr 3e-3, B 4, S 32) through the
    launcher at its ``smoke`` preset, 30 steps."""
    assert launcher.main(["--preset", "smoke", "--device", "cpu", "--steps", "30",
                          "--seq", "32", "--lr", "3e-3", "--log-every", "10"]) == 0
    text = capsys.readouterr().out
    assert "step    30 ce=" in text and "done: ce" in text


def test_launcher_draws_the_data_from_data_vocab_ids(capsys):
    """--data-vocab keeps the model's vocabulary and narrows the chain's."""
    args = launcher.parser().parse_args(["--preset", "smoke", "--device", "cpu",
                                         "--steps", "12", "--seq", "32", "--lr", "3e-3",
                                         "--data-vocab", "64", "--log-every", "12"])
    out = launcher.train(args)
    assert out["cfg"].vocab_size == 1024 and out["ce"][-1] < out["ce"][0] - 0.5
    args.data_vocab = 2000
    with pytest.raises(ValueError, match="outside the model"):
        launcher.train(args)


def test_launcher_keeps_a_deep_vlm_finite(monkeypatch):
    """A VLM's stub patch embeddings cover the whole sequence at S <=
    frontend_tokens.  Zeros there (the JAX launcher's) make every position
    zero, each RMSNorm's gradient rsqrt(eps) times its input's, and at 24
    layers the gradient overflows; the launcher draws them from its seed,
    and one step of internvl2-1b at 24 layers (narrow widths, float32) keeps
    the cross entropy and the gradient norm finite."""
    deep = dataclasses.replace(launcher.build_config("internvl2-1b", "smoke"), num_layers=24)
    monkeypatch.setattr(launcher, "build_config", lambda arch, preset: deep)
    args = launcher.parser().parse_args(["--arch", "internvl2-1b", "--preset", "smoke",
                                         "--device", "cpu", "--steps", "1", "--batch", "2",
                                         "--seq", "32"])
    out = launcher.train(args)
    assert np.isfinite(out["ce"][0]) and np.isfinite(out["grad_norm"][0]), out


def test_launcher_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--preset", "smoke", "--steps", "1"])

"""The port's Wan I2V modules and the slice as a whole, held against the JAX
package at the SMALL profile on the CPU.

Weights, inputs and noise are made with numpy from a seed and fed to both
frameworks; the port gets the weights through ``params_from_numpy`` (the
JAX layout -> per-layer lists and OIHW convs).  The JAX side runs as its
own tests run it on the CPU: attention and the DDIM update through its
plain reference branches.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.wan_i2v import SMALL as JAX_SMALL
from repro.models.aigc import dit as jdit
from repro.models.aigc import text_encoder as jtext
from repro.models.aigc import vae as jvae
from repro_torch.configs.wan_i2v import SMALL
from repro_torch.convert import params_from_numpy
from repro_torch.models.aigc import dit, text_encoder, vae
from repro_torch.models.param import count

#: Small shapes gain nothing from many intra-op threads; the suite's other
#: workers (some timing-sensitive) share the machine's cores.
torch.set_num_threads(2)

#: float32 module parity, as docs/kernels.md gives it
TOL = dict(atol=2e-5, rtol=2e-5)


def numpy_params(spec, rng, name=""):
    """A numpy weight tree for a JAX ParamSpec tree: normal with std
    1/sqrt(fan_in) over the contracted axes (the layer axis of stacked
    leaves is not one), so that activations stay O(1) and a 2e-5 tolerance
    measures float32 rounding; 0.006 for the "small" leaves; 0.1 for the
    leaves initialized to zeros (the norm scales), so ``1 + w`` is
    exercised."""
    if isinstance(spec, dict):
        return {k: numpy_params(spec[k], rng, k) for k in sorted(spec)}
    shape = spec.shape[1:] if spec.logical[0] == "layers" else spec.shape
    if name.endswith("wo") or len(shape) == 4:   # [h, hd, d] and HWIO convs
        fan_in = int(np.prod(shape[:-1]))
    else:
        fan_in = shape[0]
    std = {"small": 0.006, "zeros": 0.1}.get(spec.init, 1 / np.sqrt(fan_in))
    return (rng.standard_normal(spec.shape) * std).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(0)
    out = {}
    for name, mod in (("text", jtext), ("vae", jvae), ("dit", jdit)):
        out[name] = numpy_params(mod.abstract_params(JAX_SMALL), rng)
    return out


@pytest.fixture(scope="module")
def port_weights(weights):
    return {k: params_from_numpy(v, device="cpu") for k, v in weights.items()}


def t(x):
    return torch.from_numpy(np.asarray(x))


def test_config_matches_jax():
    from repro.configs.wan_i2v import FULL as JAX_FULL
    from repro_torch.configs.wan_i2v import FULL, PORT

    assert SMALL == type(SMALL)(**vars(JAX_SMALL))
    assert FULL == type(FULL)(**vars(JAX_FULL))
    for f in ("text_d_model", "text_heads", "text_d_ff", "text_vocab",
              "text_len", "image_size", "vae_base_ch", "vae_latent_ch",
              "vae_downs", "dit_d_model", "dit_heads", "dit_d_ff",
              "num_frames", "patch"):
        assert getattr(PORT, f) == getattr(JAX_FULL, f), f
    assert (PORT.text_layers, PORT.dit_layers, PORT.diffusion_steps) == (2, 2, 2)
    assert PORT.video_tokens == 18_900
    assert PORT.dit_d_model // PORT.dit_heads == 128
    assert PORT.text_d_model // PORT.text_heads == 64


@pytest.mark.parametrize("mod,jmod", [(text_encoder, jtext), (vae, jvae),
                                      (dit, jdit)])
@pytest.mark.parametrize("cfg", ["SMALL", "FULL"])
def test_param_specs_match_jax(mod, jmod, cfg):
    from repro.configs import wan_i2v as jcfgs
    from repro_torch.configs import wan_i2v as cfgs

    ours = mod.abstract_params(getattr(cfgs, cfg))
    ref = jmod.abstract_params(getattr(jcfgs, cfg))

    def flat(tree, prefix=()):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in flat(tree[k], prefix + (k,))]
        return [(prefix, tuple(tree.shape), tree.init, str(tree.dtype))]

    assert flat(ours) == flat(ref)


def test_param_counts_at_port():
    from repro_torch.configs.wan_i2v import PORT

    assert 1.0e9 < count(dit.abstract_params(PORT)) < 1.1e9
    assert 0.40e9 < count(text_encoder.abstract_params(PORT)) < 0.45e9


def test_init_tree_follows_the_jax_rules():
    from repro_torch.models.param import init_tree

    g = torch.Generator().manual_seed(0)
    p = init_tree(dit.abstract_params(SMALL), g, torch.device("cpu"))
    assert float(p["final_norm"].abs().max()) == 0.0                   # zeros
    assert p["patch_out"].std().item() == pytest.approx(0.006, rel=0.1)  # small
    fan_in = p["time_mlp1"].shape[0]
    assert p["time_mlp1"].std().item() == pytest.approx(fan_in ** -0.5, rel=0.1)


@pytest.mark.parametrize("steps", [2, 4, 8, 50])
def test_timestep_schedule_identical_to_jax(steps):
    alphas, ts = dit.schedule(steps)
    ref_ts = np.asarray(jnp.linspace(999, 0, steps).astype(jnp.int32))
    np.testing.assert_array_equal(ts, ref_ts)
    betas = jnp.linspace(1e-4, 0.02, 1000)
    ref_alphas = np.asarray(jnp.cumprod(1.0 - betas))
    np.testing.assert_allclose(alphas, ref_alphas, rtol=1e-6, atol=0)


def test_encode_text_matches_jax(weights, port_weights):
    tokens = np.random.default_rng(1).integers(
        0, SMALL.text_vocab, (2, SMALL.text_len)).astype(np.int32)
    ref = jtext.encode_text(weights["text"], jnp.asarray(tokens), JAX_SMALL)
    ours = text_encoder.encode_text(port_weights["text"], t(tokens), SMALL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def assert_close_where(ours, ref, what, *, atol, rtol):
    """``np.testing.assert_allclose``'s test (|a - b| <= atol + rtol |b|),
    reporting on a mismatch the largest absolute and relative difference and
    the first differing elements with both values, so that a failure says
    which elements moved and by how much."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (what, ours.shape, ref.shape)
    bad = ~np.isclose(ours, ref, atol=atol, rtol=rtol)
    if bad.any():
        diff = np.abs(ours.astype(np.float64) - ref)
        rel = diff / np.maximum(np.abs(ref), 1e-30)
        where = "; ".join(f"{tuple(int(j) for j in i)}: port {ours[tuple(i)]:.7g} "
                          f"jax {ref[tuple(i)]:.7g}" for i in np.argwhere(bad)[:8])
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.size} elements differ beyond atol "
            f"{atol} + rtol {rtol}; max abs diff {diff.max():.3g}, max rel diff "
            f"{rel.max():.3g}; first: {where}")


def test_vae_moments_and_decode_match_jax(weights, port_weights):
    """At these weights the decoder does not saturate (pre-tanh values stay
    below 2 in magnitude), and the port's moments and frames differ from the
    JAX package's by at most 3.6e-7 and 9.7e-7 (measured), about 1/20 of
    the 2e-5 float32 tolerance."""
    rng = np.random.default_rng(2)
    frames = (rng.standard_normal((2, SMALL.image_size, SMALL.image_size, 3))
              * 0.5).astype(np.float32)
    mu, logvar = vae.moments(port_weights["vae"], t(frames), SMALL)
    rmu, rlogvar = jvae.moments(weights["vae"], jnp.asarray(frames), JAX_SMALL)
    assert_close_where(mu.numpy(), rmu, "mu", **TOL)
    assert_close_where(logvar.numpy(), rlogvar, "logvar", **TOL)

    z = rng.standard_normal(tuple(rmu.shape)).astype(np.float32)
    ours = vae.decode(port_weights["vae"], t(z), SMALL)
    ref = jvae.decode(weights["vae"], jnp.asarray(z), JAX_SMALL)
    assert_close_where(ours.numpy(), ref, "frames", **TOL)
    assert float(np.abs(np.asarray(ref)).max()) < 0.99   # unsaturated


def test_vae_same_padding_on_odd_sizes():
    """``padding="SAME"`` as XLA computes it also where the split is even."""
    from repro.models.aigc.vae import _conv as jconv
    from repro_torch.models.aigc.vae import _conv

    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
    for size in (15, 16):
        x = rng.standard_normal((1, size, size, 4)).astype(np.float32)
        for stride in (1, 2):
            ref = jconv(jnp.asarray(x), jnp.asarray(w), stride)
            ours = _conv(t(x).permute(0, 3, 1, 2), t(w).permute(3, 2, 0, 1),
                         stride).permute(0, 2, 3, 1)
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_dit_forward_matches_jax(weights, port_weights):
    rng = np.random.default_rng(4)
    pd = SMALL.patch ** 2 * SMALL.vae_latent_ch
    tokens = rng.standard_normal((2, SMALL.video_tokens, pd)).astype(np.float32)
    text = rng.standard_normal((2, SMALL.text_len, SMALL.text_d_model)).astype(np.float32)
    ts = np.array([999, 17], np.int32)
    ref = jdit.dit_forward(weights["dit"], jnp.asarray(tokens), jnp.asarray(ts),
                           jnp.asarray(text), JAX_SMALL)
    ours = dit.dit_forward(port_weights["dit"], t(tokens), t(ts), t(text), SMALL)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_patchify_roundtrip_matches_jax():
    rng = np.random.default_rng(5)
    h = SMALL.latent_size
    z = rng.standard_normal((2, SMALL.num_frames, h, h, SMALL.vae_latent_ch)
                            ).astype(np.float32)
    ours = dit.patchify(t(z), SMALL)
    np.testing.assert_array_equal(ours.numpy(),
                                  np.asarray(jdit.patchify(jnp.asarray(z), JAX_SMALL)))
    np.testing.assert_array_equal(dit.unpatchify(ours, SMALL).numpy(), z)


#: The slice end to end: text -> VAE encode (with given reparam noise) ->
#: DDIM sampling (with given initial noise) -> VAE decode.  The first DDIM
#: step (t = 999) multiplies the latent by sqrt(a_p / a_t), so latents reach
#: |x| ~ 570 here and an absolute tolerance has to follow that scale: held to
#: atol 5e-4 (the two frameworks differ by at most 2.1e-4 on this input,
#: 3.8e-7 of the largest latent) and rtol 2e-5.  Frames are held to 1e-3
#: (measured: 1.5e-4): the decoder's gain carries the latents' rounding
#: differences into the frames (the JAX package's own batched and monolithic
#: frames differ by up to 0.048 in 2 of 12,288 elements).
LATENT_TOL = dict(atol=5e-4, rtol=2e-5)
FRAME_TOL = dict(atol=1e-3, rtol=0)


def test_slice_latents_and_frames_match_jax(weights, port_weights):
    cfg = SMALL
    rng = np.random.default_rng(6)
    b = 2
    tokens = rng.integers(0, cfg.text_vocab, (b, cfg.text_len)).astype(np.int32)
    image = (rng.standard_normal((b, cfg.image_size, cfg.image_size, 3))
             * 0.1).astype(np.float32)
    h = cfg.latent_size
    vae_noise = rng.standard_normal((b, h, h, cfg.vae_latent_ch)).astype(np.float32)
    pd = cfg.patch ** 2 * cfg.vae_latent_ch
    ddim_noise = rng.standard_normal((b, cfg.video_tokens, pd)).astype(np.float32)

    # JAX reference
    temb = jtext.encode_text(weights["text"], jnp.asarray(tokens), JAX_SMALL)
    mu, logvar = jvae.moments(weights["vae"], jnp.asarray(image), JAX_SMALL)
    z = mu + jnp.exp(0.5 * logvar) * jnp.asarray(vae_noise)
    zt = jdit.patchify(jnp.repeat(z[:, None], cfg.num_frames, axis=1), JAX_SMALL)
    ref_lat = jdit.ddim_sample(weights["dit"], zt, temb, JAX_SMALL, None,
                               noise=jnp.asarray(ddim_noise))
    ref_frames = jvae.decode(weights["vae"],
                             jdit.unpatchify(ref_lat, JAX_SMALL)[0], JAX_SMALL)

    # the port
    P = port_weights
    otemb = text_encoder.encode_text(P["text"], t(tokens), cfg)
    oz, _, _ = vae.encode_batched(P["vae"], t(image), cfg, noise=t(vae_noise))
    ozt = dit.patchify(oz[:, None].expand(b, cfg.num_frames, *oz.shape[1:]), cfg)
    lat = dit.ddim_sample(P["dit"], ozt, otemb, cfg, noise=t(ddim_noise))
    frames = vae.decode(P["vae"], dit.unpatchify(lat, cfg)[0], cfg)

    np.testing.assert_allclose(oz.numpy(), np.asarray(z), **TOL)
    np.testing.assert_allclose(lat.numpy(), np.asarray(ref_lat), **LATENT_TOL)
    np.testing.assert_allclose(frames.numpy(), np.asarray(ref_frames), **FRAME_TOL)
    assert np.isfinite(frames.numpy()).all()

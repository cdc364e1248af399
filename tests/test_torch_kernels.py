"""The port's kernels held against the JAX package's.

On the CPU each wrapper of ``repro_torch.kernels`` runs its plain PyTorch
version; here that version is compared with the Pallas kernel run in
interpret mode (and the DDIM step also with the JAX two-step oracle), on the
same inputs made with numpy from a seed.  Tolerance: float32 2e-5, as
docs/kernels.md gives it.  The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ddim_step import ddim_step as jax_ddim_step
from repro.kernels.ddim_step.ref import ddim_step_ref as jax_ddim_two_step
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import ddim_step, flash_attention
from repro_torch.kernels.ddim_step import ddim_coefs
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.models.aigc.dit import schedule

#: Small shapes gain nothing from many intra-op threads; the suite's other
#: workers (some timing-sensitive) share the machine's cores.
torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-5)

FLASH_CASES = [
    # b, sq, sk, h, kv, d, causal
    (1, 64, 64, 2, 2, 32, False),      # square, one block
    (2, 40, 24, 4, 4, 64, False),      # cross attention, Sq != Sk
    (2, 33, 97, 6, 2, 32, False),      # GQA, Sq != Sk, neither a block multiple
    (1, 70, 70, 4, 2, 32, True),       # causal GQA, ragged tail
    (1, 150, 150, 2, 1, 128, True),    # causal, head_dim 128, past one block
]


def _qkv(seed, b, sq, sk, h, kv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", FLASH_CASES)
def test_flash_plain_matches_pallas_interpret(b, sq, sk, h, kv, d, causal):
    q, k, v = _qkv(0, b, sq, sk, h, kv, d)
    ours = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=causal, block_q=32, block_k=32, interpret=True)
    assert ours.shape == (b, sq, h, d)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


def test_flash_plain_chunks_query_rows():
    """Chunking the query rows (how the plain version bounds its memory at
    the DiT's 18,900 tokens) does not change the result."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 45, 45, 2, 1, 32))
    whole = attention_ref(q, k, v, causal=True)
    chunked = attention_ref(q, k, v, causal=True, q_chunk=8)
    torch.testing.assert_close(chunked, whole, atol=0, rtol=0)


def test_flash_rejects_what_it_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 16, 24, 2, 2, 32))
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, k, v, causal=True)
    with pytest.raises(ValueError, match="do not group"):
        flash_attention(torch.zeros(1, 16, 3, 32), k, v)
    # off the CPU, a tensor that is not on a CUDA device raises: there is no
    # quiet fall-back to the plain version
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


@pytest.mark.parametrize("shape", [(2, 37, 16), (1, 1000), (3, 5, 7, 4)])
@pytest.mark.parametrize("steps,i", [(4, 0), (4, 2), (50, 49), (8, 3)])
def test_ddim_plain_matches_pallas_and_two_step(shape, steps, i):
    alphas, ts = schedule(steps)
    a_t = alphas[ts[i]]
    a_p = alphas[ts[i + 1]] if i + 1 < steps else alphas[0]
    rng = np.random.default_rng(i)
    x = rng.standard_normal(shape).astype(np.float32)
    eps = rng.standard_normal(shape).astype(np.float32)
    ours = ddim_step(torch.from_numpy(x), torch.from_numpy(eps), a_t, a_p).numpy()
    fused = jax_ddim_step(jnp.asarray(x), jnp.asarray(eps), a_t, a_p,
                          interpret=True)
    two_step = jax_ddim_two_step(jnp.asarray(x), jnp.asarray(eps), a_t, a_p)
    np.testing.assert_allclose(ours, np.asarray(fused), **TOL)
    np.testing.assert_allclose(ours, np.asarray(two_step), **TOL)


def test_ddim_coefs_are_float32():
    c1, c2 = ddim_coefs(np.float32(0.5), np.float32(0.9))
    assert np.float32(c1) == c1 and np.float32(c2) == c2
    assert c1 == pytest.approx(np.sqrt(0.9 / 0.5), rel=1e-6)
    assert c2 == pytest.approx(np.sqrt(0.1) - np.sqrt(0.9 / 0.5) * np.sqrt(0.5),
                               rel=1e-5)


def test_ddim_rejects_what_it_does_not_take():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="differ"):
        ddim_step(x, torch.zeros(4, 9), 0.5, 0.9)
    with pytest.raises(ValueError, match="CUDA"):
        ddim_step(x.to("meta"), x.to("meta"), 0.5, 0.9)


#: The bfloat16 kernel's (``flash_attention_bf16.cu``) check on the card:
#: each output element within one bfloat16 step of the exact-softmax plain
#: version, |a - b| <= 2^-7 |b| + 1e-5.  Both compute in float32 and round
#: once to bfloat16, so they differ by at most one step where the two float32
#: results straddle a rounding boundary; the 1e-5 covers float32 summation
#: order near zero.
BF16_RTOL, BF16_ATOL = 2 ** -7, 1e-5
KERNEL_BK = 64          # keys per kv tile in flash_attention_bf16.cu


def _emulate_bf16_kernel(q, k, v, split_p: bool):
    """The tensor-core kernel's arithmetic for one causal head, in torch on
    the CPU: float32 scores of the bfloat16 inputs in log2 units, the online
    softmax over key blocks of KERNEL_BK with m, l and the accumulator in
    float32, l summed from the float32 p, and P V as hi V + lo V (hi =
    bf16(p), lo = bf16(p - hi)) or, as the TPU kernel does, bf16(p) V; the
    output rounded to bfloat16 once."""
    sq, d = q.shape
    scale = d ** -0.5 * 1.4426950408889634
    m = torch.full((sq, 1), -torch.inf)
    l = torch.zeros(sq, 1)
    acc = torch.zeros(sq, d)
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, sq, KERNEL_BK):
        kb, vb = k[k0:k0 + KERNEL_BK].float(), v[k0:k0 + KERNEL_BK].float()
        s = (q.float() @ kb.T) * scale
        s = s.masked_fill(torch.arange(k0, k0 + kb.shape[0])[None, :] > qpos, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        pv = hi @ vb + ((p - hi).bfloat16().float() @ vb if split_p else 0)
        acc = acc * corr + pv
        m = m_new
    return (acc / l).bfloat16()


@pytest.mark.parametrize("split_p", [True, False])
def test_bf16_kernel_numerics_meet_one_bf16_step_only_with_split_p(split_p):
    """Why the bfloat16 kernel takes P V as hi V + lo V: at S 512, causal, 2
    heads of 128, with q, k, v ~ N(0, 1) in bfloat16, the emulated kernel
    stays within one bfloat16 step of ``attention_ref``; rounding p to
    bfloat16 once moves the early causal rows, where a few keys carry the
    weight, by more than ten steps."""
    rng = np.random.default_rng(16)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 512, 2, 128)).astype(np.float32))
               .bfloat16() for _ in range(3))
    ref = attention_ref(q, k, v, causal=True).float()
    out = torch.stack([_emulate_bf16_kernel(q[0, :, h], k[0, :, h], v[0, :, h], split_p)
                       for h in range(2)], dim=1)[None].float()
    share = float(((out - ref).abs() / (BF16_ATOL + BF16_RTOL * ref.abs())).max())
    if split_p:
        assert share <= 1.0, share
    else:
        assert share > 10.0, share


LOG2E = 1.4426950408889634


def _tf32(x):
    """What a tensor core reads of a float32 as TF32: the low 13 mantissa
    bits dropped (truncation)."""
    return (x.view(torch.int32) & ~0x1fff).view(torch.float32)


def _tf32_rna(x):
    """float32 rounded to TF32 to nearest, ties away, as cvt.rna.tf32.f32."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1fff).view(torch.float32)


def _tf32_product(a, b, split: str):
    """a @ b as the tensor cores take it from float32 operands.  "one": a
    single TF32 product.  "split": the kernel's 3xTF32, hi = x (read
    truncated), lo = x - tf32(x) (read truncated in its turn), summed as
    (lo hi' + hi lo') + hi hi'.  "mixed": the same with lo taken against a
    hi rounded to nearest while the tensor core truncates hi."""
    ah, bh = _tf32(a), _tf32(b)
    if split == "one":
        return ah @ bh
    against = _tf32_rna if split == "mixed" else _tf32
    al, bl = _tf32(a - against(a)), _tf32(b - against(b))
    return (al @ bh + ah @ bl) + ah @ bh


def _emulate_f32_kernel(q, k, v, causal: bool, qk: str, pv: str):
    """The float32 kernel's arithmetic for one head, in torch on the CPU:
    Q scaled, then S = Q K^T over key tiles of KERNEL_BK as ``qk`` says; the
    online softmax with m, l and the accumulator in float32 and p = 2^(s
    log2(e) - m log2(e)); l summed from the float32 p; P V as ``pv`` says."""
    sq, d = q.shape
    q = q * d ** -0.5
    m = torch.full((sq, 1), -torch.inf)
    ml = torch.full((sq, 1), -torch.inf)
    l = torch.zeros(sq, 1)
    acc = torch.zeros(sq, d)
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, k.shape[0], KERNEL_BK):
        kb, vb = k[k0:k0 + KERNEL_BK], v[k0:k0 + KERNEL_BK]
        s = _tf32_product(q, kb.T.contiguous(), qk)
        if causal:
            s = s.masked_fill(torch.arange(k0, k0 + kb.shape[0])[None, :] > qpos, -torch.inf)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        mln = torch.where(mn == -torch.inf, torch.zeros_like(mn), mn * LOG2E)
        corr = torch.exp2(ml - mln)
        p = torch.exp2(s * LOG2E - mln)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _tf32_product(p, vb, pv)
        m, ml = mn, mln
    return acc / l


#: band (rows, keys, causal) and the arithmetic of S and of P V.  The
#: kernel's split, 3xTF32 on both products, at a band of 64 DiT rows against
#: all 18,900 keys of a head of 128 and at 300 causal keys; at 300 causal
#: keys each shortcut: one TF32 product, one product unsplit, and a lo taken
#: against the other rounding.
F32_NUMERICS = [
    ("dit_band", "split", "split"),
    ("causal_300", "split", "split"),
    ("causal_300", "one", "one"),
    ("causal_300", "split", "one"),
    ("causal_300", "one", "split"),
    ("causal_300", "mixed", "mixed"),
]
F32_BANDS = {"dit_band": (64, 18900, False), "causal_300": (300, 300, True)}


@pytest.mark.parametrize("band,qk,pv", F32_NUMERICS)
def test_f32_kernel_numerics_meet_the_limit_only_with_3xtf32_on_both_products(band, qk, pv):
    """Why the float32 kernel takes both products as 3xTF32 with hi and lo
    from the same rounding: with q, k, v ~ N(0, 1) at D 128, the emulated
    kernel stays within a tenth of the float32 limit of ``attention_ref``
    (each element within ``TOL``, as the card tests hold the kernel);
    every shortcut exceeds the limit at 300 causal keys, where a few keys
    carry a row's weight."""
    rows, keys, causal = F32_BANDS[band]
    rng = np.random.default_rng(17)
    q = torch.from_numpy(rng.standard_normal((rows, 128)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((keys, 128)).astype(np.float32))
            for _ in range(2))
    ref = attention_ref(q[None, :, None], k[None, :, None], v[None, :, None],
                        causal=causal)[0, :, 0]
    out = _emulate_f32_kernel(q, k, v, causal, qk, pv)
    share = float(((out - ref).abs() / (TOL["atol"] + TOL["rtol"] * ref.abs())).max())
    if qk == pv == "split":
        assert share <= 0.1, share
    else:
        assert share > 1.0, share


def test_cpu_calls_do_not_count_as_launches():
    before = (flash_attention.launches, ddim_step.launches)
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 8, 8, 1, 1, 32))
    flash_attention(q, k, v)
    ddim_step(q, k, 0.5, 0.9)
    assert (flash_attention.launches, ddim_step.launches) == before

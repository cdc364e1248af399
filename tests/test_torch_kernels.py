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


def _bf16_terms(x, terms: int) -> list:
    """float32 ``x`` as ``terms`` bfloat16 terms (hi, mid, lo), each the
    rounding of what the ones before it leave, in float64."""
    out, rest = [], x.float()
    for _ in range(terms):
        t = rest.bfloat16().float()
        out.append(t.double())
        rest = rest - t
    return out


def _emulate_bf16_kernel(q, k, v, terms: int):
    """The tensor-core kernel's arithmetic for one causal head, in torch on
    the CPU: float32 scores of the bfloat16 inputs in log2 units, the online
    softmax over key blocks of KERNEL_BK with m, l and p in float32, l summed
    from the float32 p, and P V with p as ``terms`` bfloat16 terms: 3 (hi +
    mid + lo, the kernel), 2 (hi + lo, the kernel before) or, as the TPU
    kernel does, 1 (bf16(p)); the products and their sums in float64, the
    output rounded to bfloat16 once."""
    sq, d = q.shape
    scale = d ** -0.5 * 1.4426950408889634
    m = torch.full((sq, 1), -torch.inf)
    l = torch.zeros(sq, 1)
    acc = torch.zeros(sq, d, dtype=torch.float64)
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, sq, KERNEL_BK):
        kb, vb = k[k0:k0 + KERNEL_BK].double(), v[k0:k0 + KERNEL_BK].double()
        s = (q.double() @ kb.T).float() * scale
        s = s.masked_fill(torch.arange(k0, k0 + kb.shape[0])[None, :] > qpos, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr.double() + sum(t @ vb for t in _bf16_terms(p, terms))
        m = m_new
    return (acc / l.double()).bfloat16()


def _heads_bf16(seed, v_scale: float, n: int = 3):
    """n tensors [1, 512, 2, 128] ~ N(0, 1) in bfloat16 from ``seed``, the
    third (v) times ``v_scale`` (a power of two: exact)."""
    rng = np.random.default_rng(seed)
    out = [torch.from_numpy(rng.standard_normal((1, 512, 2, 128)).astype(np.float32))
           .bfloat16() for _ in range(n)]
    out[2] = out[2] * v_scale
    return out


def _share(out, ref) -> float:
    """The largest share of the bfloat16 elementwise limit of out from ref."""
    out, ref = out.double(), ref.double()
    return float(((out - ref).abs() / (BF16_ATOL + BF16_RTOL * ref.abs())).max())


@pytest.mark.parametrize("split_p", [True, False])
def test_bf16_kernel_numerics_meet_one_bf16_step_only_with_split_p(split_p):
    """Why the bfloat16 kernel splits p before P V: at S 512, causal, 2
    heads of 128, with q, k, v ~ N(0, 1) in bfloat16, the emulated kernel
    with p in two bfloat16 terms stays within one bfloat16 step of
    ``attention_ref``; rounding p to bfloat16 once moves the early causal
    rows, where a few keys carry the weight, by more than ten steps."""
    q, k, v = _heads_bf16(16, 1.0)
    ref = attention_ref(q, k, v, causal=True).float()
    out = torch.stack([_emulate_bf16_kernel(q[0, :, h], k[0, :, h], v[0, :, h],
                                            2 if split_p else 1)
                       for h in range(2)], dim=1)[None].float()
    share = _share(out, ref)
    if split_p:
        assert share <= 1.0, share
    else:
        assert share > 10.0, share


def _attention64(q, k, v, do, o):
    """o, dq, dk, dv of one causal head in float64, [S, D] each: softmax(q
    k^T / sqrt(D)) v and the gradient for ``do`` given the forward's output
    ``o`` (delta = rowsum(dO o)), as the backward kernel takes it."""
    q, k, v, do, o = (x.double() for x in (q, k, v, do, o))
    scale = q.shape[-1] ** -0.5
    s = (q @ k.T) * scale
    p = s.masked_fill(torch.ones_like(s, dtype=torch.bool).triu(1), -torch.inf).softmax(-1)
    ds = p * (do @ v.T - (do * o).sum(-1, keepdim=True))
    return p @ v, ds @ k * scale, ds.T @ q * scale, p.T @ do


@pytest.mark.parametrize("terms", [2, 3])
def test_bf16_kernel_numerics_at_large_v_meet_the_limit_only_with_three_terms(terms):
    """Why the bfloat16 kernel takes p in three bfloat16 terms: with V x 2^7
    (|v| ~ 150 and a spread softmax, as the init rule's weights make
    qwen3-1.7b's layer inputs), an output that cancels keeps 2^-17 sum |p v|
    / l of two terms' error, past the limit's absolute part.  At S 512,
    causal, 2 heads of 128, q, k ~ N(0, 1), the emulated kernel with two
    terms lies 3.6 of the elementwise limit from the float64 result, with
    three within 1.  Held from float64, not from ``attention_ref``: the
    plain float32 path itself lies ~1.27 of the limit from float64 here (a
    reading that moves with the CPU's summation order, so not asserted)."""
    q, k, v = _heads_bf16(16, 2.0 ** 7)
    out = torch.stack([_emulate_bf16_kernel(q[0, :, h], k[0, :, h], v[0, :, h], terms)
                       for h in range(2)], dim=1)
    exact = torch.stack([_attention64(q[0, :, h], k[0, :, h], v[0, :, h], q[0, :, h],
                                      q[0, :, h])[0] for h in range(2)], dim=1)
    share = _share(out, exact)
    if terms == 3:
        assert share <= 1.0, share
    else:
        assert share > 2.0, share


def _emulate_bf16_backward(q, k, v, o, do, terms: int):
    """The bfloat16 backward kernel's splits for one causal head, [S, D]
    each: dq += dS K and dk += dS^T Q with dS = P (dP - delta) rounded to
    float32 and taken as ``terms`` bfloat16 terms, dv += P^T dO with P in
    two; S, P, dP, delta and every product in float64, each result rounded
    to bfloat16 once."""
    q, k, v, o, do = (x.double() for x in (q, k, v, o, do))
    scale = q.shape[-1] ** -0.5
    s = (q @ k.T) * scale
    p = s.masked_fill(torch.ones_like(s, dtype=torch.bool).triu(1), -torch.inf).softmax(-1)
    ds = p * (do @ v.T - (do * o).sum(-1, keepdim=True))
    dq = sum(t @ k for t in _bf16_terms(ds, terms)) * scale
    dk = sum(t.T @ q for t in _bf16_terms(ds, terms)) * scale
    dv = sum(t.T @ do for t in _bf16_terms(p, 2))
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16()


@pytest.mark.parametrize("terms", [2, 3])
def test_bf16_backward_numerics_at_large_v_meet_the_limit_only_with_three_terms(terms):
    """Why the bfloat16 backward takes dS in three bfloat16 terms for dq
    and dk: at S 512, causal, 2 heads of 128, q, k, dO ~ N(0, 1) and V x
    2^7, dq and dk sum terms of dS that cancel (each row sums to 0), and two
    terms leave them more than 1 of the elementwise limit from the float64
    gradient (given the bfloat16 o), dk most (~6.8); three terms stay
    within it.  dv = P^T dO does not cancel, and P in two terms keeps it
    within 1 either way.  S, P, dP and delta are float64 here: the kernel's
    float32 ones add their own error, which the card measures."""
    q, k, v, do = _heads_bf16(16, 2.0 ** 7, 4)
    o = attention_ref(q, k, v, causal=True)
    dq, dk, dv = [], [], []
    for h in range(2):
        ours = _emulate_bf16_backward(q[0, :, h], k[0, :, h], v[0, :, h], o[0, :, h],
                                      do[0, :, h], terms)
        exact = _attention64(q[0, :, h], k[0, :, h], v[0, :, h], do[0, :, h], o[0, :, h])[1:]
        for acc, a, e in zip((dq, dk, dv), ours, exact):
            acc.append(_share(a, e))
    assert max(dv) <= 1.0, dv
    if terms == 3:
        assert max(dq + dk) <= 1.0, (dq, dk)
    else:
        assert max(dq + dk) > 1.0, (dq, dk)


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


def _trunc32(x):
    """float64 to float32 rounded toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def _wgmma(a, b, split: str, acc=None):
    """acc + a @ b as the float32 backward's `wgmma` takes it: operands read
    as TF32 (truncated); "split" issues lo hi', hi lo', hi hi' in turn and
    "one" hi hi' alone, each over the contraction in steps of 8, each
    step's exact sum added into the float32 accumulator with truncation
    toward zero, as the tensor core adds it; ``acc`` None is a zeroed
    accumulator."""
    ah, bh = _tf32(a).double(), _tf32(b).double()
    pairs = [(ah, bh)]
    if split == "split":
        pairs = [(_tf32(a - _tf32(a)).double(), bh), (ah, _tf32(b - _tf32(b)).double()), (ah, bh)]
    acc = torch.zeros(a.shape[0], b.shape[1]) if acc is None else acc
    for x, y in pairs:
        for k0 in range(0, a.shape[1], 8):
            acc = _trunc32(acc.double() + x[:, k0:k0 + 8] @ y[k0:k0 + 8])
    return acc


def _emulate_f32_backward(q, k, v, o, do, lse, causal: bool, split: str, tiles: bool):
    """The float32 backward kernel's arithmetic (``flash_attention_bwd.cu``),
    in torch on the CPU: q, o, do [Sq, H, D], k, v [Sk, KV, D], lse [H, Sq].
    S = Q K^T and dP = dO V^T on the q side, S^T = K Q^T and dP^T = V dO^T
    on the kv side (operands in the other order), each one accumulator;
    P = 2^(S scale log2 e - lse log2 e), masked, dS = P (dP - delta) in
    float32; dQ summed over tiles of keys, dK and dV over the group's query
    heads and their tiles of rows: 64 a tile, but 32 for dQ and dK at D 128.
    ``tiles``: each tile's product in a zeroed accumulator and added in
    float32, as the kernel does, or every tile left in one accumulator.
    ``split``: every product 3xTF32 ("split") or one TF32 product ("one")."""
    sq, h, d = q.shape
    sk, kv = k.shape[:2]
    g, bn = h // kv, 32 if d == 128 else 64
    scale = d ** -0.5
    sl2 = torch.tensor(scale * LOG2E, dtype=torch.float32).double()
    keep = torch.arange(sk)[None, :] <= torch.arange(sq)[:, None] if causal else None

    def probs(s, lse2, keep):
        p = torch.exp2((s.double() * sl2 - lse2.double()).float())
        return p if keep is None else p.masked_fill(~keep, 0.)

    def tiled(a, b, acc, rows=bn):
        """acc + sum over tiles of ``rows`` along the contraction of a @ b."""
        for c0 in range(0, a.shape[1], rows):
            a_t, b_t = a[:, c0:c0 + rows], b[c0:c0 + rows]
            acc = acc + _wgmma(a_t, b_t, split) if tiles else _wgmma(a_t, b_t, split, acc)
        return acc
    dq = torch.empty(sq, h, d)
    dk, dv = torch.zeros(sk, kv, d), torch.zeros(sk, kv, d)
    for hi in range(h):
        qh, doh, kh, vh = q[:, hi], do[:, hi], k[:, hi // g], v[:, hi // g]
        lse2 = lse[hi] * LOG2E
        delta = (doh * o[:, hi]).sum(-1)
        p = probs(_wgmma(qh, kh.T, split), lse2[:, None], keep)
        ds = p * (_wgmma(doh, vh.T, split) - delta[:, None])
        dq[:, hi] = tiled(ds, kh, torch.zeros(sq, d)) * scale
        pt = probs(_wgmma(kh, qh.T, split), lse2[None, :], None if keep is None else keep.T)
        dst = pt * (_wgmma(vh, doh.T, split) - delta[None, :])
        dv[:, hi // g] = tiled(pt, doh, dv[:, hi // g], 64)
        dk[:, hi // g] = tiled(dst, qh, dk[:, hi // g])
    return dq, dk * scale, dv


def _grads64(q, k, v, do, causal: bool):
    """dq, dk, dv of softmax(q k^T / sqrt(D)) v for the output gradient do,
    by autograd in float64: q, do [Sq, H, D], k, v [Sk, KV, D]."""
    g = q.shape[1] // k.shape[1]
    q, k, v = (x.double().requires_grad_() for x in (q, k, v))
    s = torch.einsum("qhd,khd->hqk", q, k.repeat_interleave(g, 1)) * q.shape[-1] ** -0.5
    if causal:
        s = s.masked_fill(torch.ones(s.shape[1:], dtype=torch.bool).triu(1), -torch.inf)
    o = torch.einsum("hqk,khd->qhd", s.softmax(-1), v.repeat_interleave(g, 1))
    return torch.autograd.grad(o, (q, k, v), do.double())


#: band (rows, keys, query heads, kv heads, causal, dO's scale) and the
#: backward's arithmetic (products, tiles).  The kernel's: 3xTF32 on every
#: product, each tile's sum outside the accumulator, at a band of 64 DiT
#: rows over 2048 keys, a causal GQA band (all 256 rows of two query heads
#: over one kv head) and a band whose last 64-key tile is ragged (2000
#: keys); then at the DiT band one TF32 product, and every tile left in one
#: accumulator.  dO ~ N(0, 1) x 64 puts the DiT and ragged bands' dq, dk and
#: dv (|.| up to ~10) under the limit's relative part, where a bias toward
#: zero shows; at N(0, 1) the absolute part (2e-5) holds them and hides it.
#: The causal band keeps dO ~ N(0, 1), as the card tests draw it: its first
#: rows see a few keys, dS = P (dP - delta) cancels there, and at dO x 64
#: float32 rounding alone reaches the limit.  At dO x 64 ``attention_bwd_ref``
#: lies 0.25-0.3 of the limit from the float64 gradient by its own float32
#: sums, an amount that moves with the CPU's summation order, so the
#: emulation is held to the float64 gradient.
F32_BWD_NUMERICS = [
    ("dit_band", "split", True),
    ("causal_gqa", "split", True),
    ("ragged", "split", True),
    ("dit_band", "one", True),
    ("dit_band", "split", False),
]
F32_BWD_BANDS = {"dit_band": (64, 2048, 1, 1, False, 64.0),
                 "causal_gqa": (256, 256, 2, 1, True, 1.0),
                 "ragged": (64, 2000, 1, 1, False, 64.0)}


@pytest.mark.parametrize("band,split,tiles", F32_BWD_NUMERICS)
def test_f32_backward_numerics_meet_the_limit_only_with_3xtf32_and_tiled_sums(band, split,
                                                                               tiles):
    """Why the float32 backward takes every product as 3xTF32 and adds each
    tile's sum outside the tensor core's accumulator: at D 128, with q, k,
    v ~ N(0, 1) and dO as `F32_BWD_BANDS` scales it, the emulated kernel
    keeps dq, dk and dv within the float32 limit of the float64 gradient
    (each element within ``TOL``, as the card tests hold the kernel to
    ``attention_bwd_ref``), also with causal and ragged masks; one TF32
    product misses it over 100-fold, the sums of all 64 key tiles left in
    one accumulator (768 truncated additions into dq) over twofold."""
    rows, keys, h, kv, causal, do_scale = F32_BWD_BANDS[band]
    rng = np.random.default_rng(26)
    q = torch.from_numpy(rng.standard_normal((1, rows, h, 128)).astype(np.float32))
    do = torch.from_numpy((rng.standard_normal((1, rows, h, 128)) * do_scale)
                          .astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, keys, kv, 128)).astype(np.float32))
            for _ in range(2))
    o, lse = attention_ref(q, k, v, causal=causal, return_lse=True)
    out = _emulate_f32_backward(q[0], k[0], v[0], o[0], do[0], lse[0], causal, split, tiles)
    share = max(float(((a - b).abs() / (TOL["atol"] + TOL["rtol"] * b.abs())).max())
                for a, b in zip(out, _grads64(q[0], k[0], v[0], do[0], causal)))
    if split == "split" and tiles:
        assert share <= 1.0, share
    else:
        assert share > (100.0 if split == "one" else 2.0), share


#: The WKV6 kernel's (``rwkv6_wkv/csrc/wkv6.cu``) checks on the card, as
#: ``tests/test_torch_cuda.py`` holds it: y element by element within
#: |a - b| <= rtol |b| + 1e-5 max|b| (rtol float32 2e-5, bfloat16 one step
#: 2^-7) and the state within 1e-4 (1 + |b|).
WKV_RTOL = {torch.float32: 2e-5, torch.bfloat16: 2 ** -7}
WKV_CHUNK, WKV_SUB = 64, 8       # time steps per chunk and per sub-chunk in wkv6.cu


def _wkv_product(a, b, how: str):
    """a @ b as the WKV6 kernel's tensor cores take it: "split" 3xTF32 as
    ``_tf32_product``; "tf32" one TF32 product; "bf16" one product of the
    operands rounded to bfloat16."""
    if how == "bf16":
        return a.bfloat16().float() @ b.bfloat16().float()
    return _tf32_product(a, b, "one" if how == "tf32" else "split")


def _emulate_wkv6_kernel(r, k, v, w, u, s0, product: str, cross: str):
    """The WKV6 kernel's arithmetic for one head, in torch on the CPU: r, k,
    v, w [T, K] as float32, u [K], s0 [K, V].  Chunks of WKV_CHUNK steps
    (the ragged end padded with r = k = v = 0, w = 1), sub-chunks of
    WKV_SUB; the decays within a sub-chunk multiplied up step by step
    (Rl_i = r_i w_s .. w_{i-1} from the sub-chunk's start s, Kl_j = k_j
    w_{j+1} .. w_{e-1} to its end e), the whole sub-chunks' products G; the
    pairs inside a sub-chunk summed directly with their decay multiplied up
    from i down to j; the rest as products by ``product``: A between
    sub-chunks a > b as (Rl_a G_{b+1} .. G_{a-1}) Kl_b^T (``cross`` "sub"),
    or factored against the chunk's start, (Rl_a G_0 .. G_{a-1}) (Kl_b
    G_{b+1} .. G_3 / G_0 .. G_3)^T ("start"); y = (Rl G_pre) S + A V; S <-
    G_tot S + (Kl G_suf)^T V."""
    n_t, kk = r.shape
    s = s0.clone()
    ys = []
    for c0 in range(0, n_t, WKV_CHUNK):
        n = min(WKV_CHUNK, n_t - c0)

        def pad(x, fill):
            return torch.cat([x[c0:c0 + n], torch.full((WKV_CHUNK - n, kk), fill)])
        rc, kc, vc, wc = pad(r, 0.), pad(k, 0.), pad(v, 0.), pad(w, 1.)
        rl, kl, g = torch.empty_like(rc), torch.empty_like(kc), []
        for a0 in range(0, WKV_CHUNK, WKV_SUB):
            c = torch.ones(kk)
            for i in range(a0, a0 + WKV_SUB):
                rl[i], c = rc[i] * c, c * wc[i]
            g.append(c)
            c = torch.ones(kk)
            for j in range(a0 + WKV_SUB - 1, a0 - 1, -1):
                kl[j], c = kc[j] * c, c * wc[j]
        nsub = len(g)
        ones = torch.ones(kk)
        pre = [torch.stack([ones] + g[:a]).prod(0) for a in range(nsub)]
        suf = [torch.stack([ones] + g[b + 1:]).prod(0) for b in range(nsub)]
        tot = torch.stack(g).prod(0)
        att = torch.zeros(WKV_CHUNK, WKV_CHUNK)
        for i in range(WKV_CHUNK):
            a0 = i - i % WKV_SUB
            att[i, i] = (u * rc[i] * kc[i]).sum()
            rd = rc[i]
            for j in range(i - 1, a0 - 1, -1):
                if j < i - 1:
                    rd = rd * wc[j + 1]
                att[i, j] = (rd * kc[j]).sum()
        for a in range(1, nsub):
            rows = slice(a * WKV_SUB, (a + 1) * WKV_SUB)
            for b in range(a):
                cols = slice(b * WKV_SUB, (b + 1) * WKV_SUB)
                if cross == "sub":
                    lhs = rl[rows] * torch.stack([ones] + g[b + 1:a]).prod(0)
                    rhs = kl[cols]
                else:
                    lhs, rhs = rl[rows] * pre[a], kl[cols] * suf[b] / tot
                att[rows, cols] = _wkv_product(lhs, rhs.T.contiguous(), product)
        rhat = torch.cat([rl[a * WKV_SUB:(a + 1) * WKV_SUB] * pre[a] for a in range(nsub)])
        khat = torch.cat([kl[b * WKV_SUB:(b + 1) * WKV_SUB] * suf[b] for b in range(nsub)])
        y = _wkv_product(rhat, s, product) + _wkv_product(att, vc, product)
        s = tot[:, None] * s + _wkv_product(khat.T.contiguous(), vc, product)
        ys.append(y[:n])
    return torch.cat(ys), s


def _model_decays(rng, shape):
    """w as rwkv6 draws it: exp(-exp(x)) rounded to bfloat16, here for x
    uniform over [-6, 4] (down to e^-54.6), with 1 % exact zeros and 1 %
    exact ones planted."""
    x = rng.uniform(-6, 4, shape).astype(np.float32)
    w = torch.from_numpy(np.exp(-np.exp(x))).bfloat16().float()
    pick = torch.from_numpy(rng.random(shape))
    return torch.where(pick < 0.01, 0., torch.where(pick > 0.99, 1., w))


#: (input type, decays, product, cross factor): the kernel's own choices
#: with the model's decays and with the tests' [0.45, 0.95]; then each
#: shortcut.
WKV_NUMERICS = [
    ("float32", "model", "split", "sub"),
    ("bfloat16", "model", "split", "sub"),
    ("float32", "tests", "split", "sub"),
    ("float32", "model", "tf32", "sub"),
    ("bfloat16", "model", "tf32", "sub"),
    ("float32", "model", "bf16", "sub"),
    ("float32", "model", "split", "start"),
]


@pytest.mark.parametrize("dtype,decays,product,cross", WKV_NUMERICS)
def test_wkv6_kernel_numerics_meet_the_limits_only_as_built(dtype, decays, product, cross):
    """Why the WKV6 kernel splits at sub-chunks and takes 3xTF32 products:
    at rwkv6-7b's head size (64), two heads, T 200 (three chunks and a
    ragged fourth) from a nonzero state, the emulated kernel stays within a
    tenth of the float32 limits of the plain loop (``wkv6_ref``) and within
    the bfloat16 one, also with the model's decays, exact zeros included;
    one TF32 product, or one bfloat16 product, misses y's float32 limit more
    than tenfold; factoring a pair across sub-chunks against the chunk's
    start turns y non-finite at the model's decays."""
    from repro_torch.kernels.rwkv6_wkv import wkv6_ref

    dt = getattr(torch, dtype)
    rng = np.random.default_rng(19)
    t_len, h, kk = 200, 2, 64

    def normal(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    r, k, v = normal(1, t_len, h, kk), normal(1, t_len, h, kk, scale=0.3), normal(1, t_len, h, kk)
    w = (_model_decays(rng, (1, t_len, h, kk)) if decays == "model"
         else torch.sigmoid(normal(1, t_len, h, kk)) * 0.5 + 0.45)
    u, s0 = normal(h, kk, scale=0.1), normal(1, h, kk, kk, scale=0.5)
    r, k, v, w, u = (x.to(dt) for x in (r, k, v, w, u))
    ref_y, ref_s = wkv6_ref(r, k, v, w, u, s0)
    outs = [_emulate_wkv6_kernel(*(x[0, :, i].float() for x in (r, k, v, w)), u[i].float(),
                                 s0[0, i], product, cross) for i in range(h)]
    y = torch.stack([o[0] for o in outs], 1)[None].to(dt).float()
    s = torch.stack([o[1] for o in outs])[None]
    b = ref_y.float()
    y_share = float(((y - b).abs() / (WKV_RTOL[dt] * b.abs() + 1e-5 * b.abs().max())).max())
    s_share = float(((s - ref_s).abs() / (1e-4 * (1 + ref_s.abs()))).max())
    if cross == "start":
        assert not torch.isfinite(y).all()
    elif product != "split":
        assert y_share > 10.0 if dt == torch.float32 else y_share > 1.0, y_share
    else:
        assert s_share <= 0.1, s_share
        assert y_share <= (0.1 if dt == torch.float32 else 1.0), y_share


def test_cpu_calls_do_not_count_as_launches():
    before = (flash_attention.launches, ddim_step.launches)
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 8, 8, 1, 1, 32))
    flash_attention(q, k, v)
    ddim_step(q, k, 0.5, 0.9)
    assert (flash_attention.launches, ddim_step.launches) == before

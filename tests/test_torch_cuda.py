"""The port's CUDA kernels on the card, against their plain PyTorch
versions; the flash and WKV6 backward kernels, the wrappers that refuse a
gradient they cannot give, and deterministic training steps.  These tests need a CUDA device and ``nvcc`` and skip elsewhere;
this file imports no JAX, so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The build's bookkeeping (the C entry points the ctypes bindings expect) is
checked everywhere.
"""
from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ddim_step, flash_attention, flash_attention_backward
from repro_torch.kernels import decode_attention as K
from repro_torch.kernels.ddim_step import ddim_coefs, ddim_step_ref
from repro_torch.kernels.flash_attention import (
    attention_bwd_ref, attention_ref, flash_attention_with_lse, ops as flash_ops)
from repro_torch.kernels.rwkv6_wkv import wkv6, wkv6_backward, wkv6_bwd_ref, wkv6_ref
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models import layers as L
from repro_torch.models.layers import rms_norm, row_mean
from repro_torch.models.aigc.dit import schedule

FLASH_CASES = [
    # b, sq, sk, h, kv, d, causal
    (1, 64, 64, 2, 2, 32, False),
    (2, 40, 24, 4, 4, 64, False),
    (2, 33, 97, 6, 2, 32, False),
    (1, 70, 70, 4, 2, 32, True),
    (1, 150, 150, 2, 1, 128, True),
    (1, 300, 512, 8, 8, 128, False),
    (1, 512, 512, 16, 16, 64, False),
]

#: docs/kernels.md: float32 2e-5, the int8 decode over float32 queries 1e-4.
#: bfloat16 outputs: kernel and plain version compute in float32 and each
#: rounds to bfloat16, so an element differs by at most one bfloat16 step
#: (2^-7 of its value); the absolute 1e-5 covers float32 summation order
#: near zero.
TOLS = {torch.float32: dict(atol=2e-5, rtol=2e-5),
        torch.bfloat16: dict(atol=1e-5, rtol=2 ** -7)}
INT8_TOLS = {torch.float32: dict(atol=1e-4, rtol=1e-4),
             torch.bfloat16: TOLS[torch.bfloat16]}

#: Grids of the flash kernels (a block per 64 query rows of a head) several
#: times wider than the card's 132 SMs, at every head size.
FLASH_WIDE_CASES = [
    # b, sq, sk, h, kv, d, causal
    (4, 300, 300, 32, 8, 32, True),
    (2, 520, 600, 40, 40, 64, False),
    (1, 700, 700, 64, 16, 128, True),
    (1, 1000, 777, 160, 160, 128, False),
]

DECODE_CASES = [
    # b, s, h, kv, d, cur (int: scalar index; list: one per row)
    (2, 64, 4, 2, 32, 37),
    (3, 600, 8, 2, 64, [599, 0, 256]),
    (8, 1024, 16, 8, 128, [1023, 700, 255, 256, 1, 0, 512, 64]),
    (2, 300, 24, 2, 128, [299, 100]),   # 12 query heads per kv head
    (1, 96, 8, 8, 128, 95),             # one query head per kv head
    (8, 1024, 14, 2, 64, [1023, 700, 255, 256, 1, 0, 512, 64]),  # groups of 7
    (8, 1024, 24, 8, 64, [1023, 700, 255, 256, 1, 0, 512, 64]),  # groups of 3
]


def test_every_binding_has_a_c_entry_point():
    sources = {p.name for p in _build.sources()}
    assert sources == {"flash_attention.cu", "flash_attention_bf16.cu",
                       "flash_attention_bwd.cu", "flash_attention_bwd_bf16.cu",
                       "ddim_step.cu", "decode_attention.cu", "wkv6.cu", "wkv6_bwd.cu",
                       "runtime.cu"}
    text = "".join(p.read_text() for p in _build.sources())
    entries = set(re.findall(r'extern "C" [\w\s*]+?\b(repro_\w+)\(', text))
    assert entries == set(_build.SIGNATURES)


def test_wkv6_backward_workspaces_are_sized_by_the_kernels_tiles():
    """ops.py sizes the backward's workspace of chunk states by the
    kernel's chunk; the two must not drift apart."""
    text = (_build.PKG / "rwkv6_wkv" / "csrc" / "wkv6_bwd.cu").read_text()
    consts = dict(re.findall(r"constexpr int (C) = (\d+);", text))
    assert int(consts["C"]) == wkv_ops.BWD_CHUNK


@pytest.mark.parametrize("b,h,sq,sk,sms,splits", [
    (4, 16, 256, 256, 132, 1),     # qwen3-1.7b's training layer: 256 blocks
    (1, 32, 512, 512, 132, 1),     # zamba2-1.2b's shared block
    (1, 20, 64, 1500, 132, 12),    # whisper's cross-attention: 20 blocks
    (2, 4, 64, 1537, 132, 13),     # 25 key tiles, 2 a split
    (1, 8, 17, 3000, 132, 24),     # 47 key tiles, 2 a split
    (1, 1, 64, 64, 132, 1),        # one key tile: nothing to split
])
def test_bf16_backward_splits_dq_only_where_its_blocks_leave_sms_idle(b, h, sq, sk, sms, splits):
    assert flash_ops.dq_splits(b, h, sq, sk, sms) == splits
    k_tiles = -(-sk // 64)
    per = -(-k_tiles // splits)
    assert -(-k_tiles // per) == splits and (splits == 1 or per >= 2)


def test_build_dir_is_ignored_by_git():
    root = _build.PKG.parents[2]
    assert _build.BUILD_DIR.relative_to(root).parts[0] == "build"
    assert "build/" in (root / ".gitignore").read_text().split()


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", FLASH_CASES)
def test_flash_kernel_matches_plain_on_card(cuda, b, sq, sk, h, kv, d, causal):
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
               for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))
    launches = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    ref = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 3, 4, 1001, 1 << 20])
def test_ddim_kernel_matches_plain_on_card(cuda, n):
    gen = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n, generator=gen, device=cuda)
    eps = torch.randn(n, generator=gen, device=cuda)
    alphas, ts = schedule(4)
    out = ddim_step(x, eps, alphas[ts[1]], alphas[ts[2]])
    torch.cuda.synchronize()
    c1, c2 = ddim_coefs(alphas[ts[1]], alphas[ts[2]])
    torch.testing.assert_close(out, ddim_step_ref(x, eps, c1, c2),
                               atol=0, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_in_both_types_matches_plain_on_card(cuda, dtype, causal):
    """qwen3's prefill shapes: 16 query heads over 8 kv heads of 128."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((1, 333, 16, 128), (1, 333, 8, 128), (1, 333, 8, 128)))
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    ref = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])


def _bf16_qkv(cuda, seed, b, sq, sk, h, kv, d):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=cuda).bfloat16()
            for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]


def _check_bf16_flash(q, k, v, causal):
    launches = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ref = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[torch.bfloat16])


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", FLASH_CASES + FLASH_WIDE_CASES)
def test_flash_bf16_kernel_matches_plain_on_card(cuda, b, sq, sk, h, kv, d, causal):
    """The tensor-core kernel at every head size, GQA, Sq != Sk, ragged
    tails, causal or not, grids narrower and wider than the card."""
    _check_bf16_flash(*_bf16_qkv(cuda, sq + d, b, sq, sk, h, kv, d), causal)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 2500])
def test_flash_bf16_kernel_at_tile_edges_on_card(cuda, s, causal):
    """Query and key counts on both sides of the 64-row warpgroup tile, the
    128-row block and the 64-key kv tile, at qwen3-1.7b's heads."""
    _check_bf16_flash(*_bf16_qkv(cuda, s, 1, s, s, 16, 8, 128), causal)


@pytest.mark.gpu
def test_flash_bf16_kernel_runs_on_the_tensor_cores(cuda):
    """The flash kernels on the tensor cores, the forward in bfloat16
    (``flash_fwd_bf16``) and in float32 as 3xTF32 (``flash_fwd_f32``) and
    the backward in bfloat16 (``flash_bwd_bf16_main``) and in float32 as
    3xTF32 (``flash_bwd_f32_main``), hold warpgroup MMAs (HGMMA) in the SASS
    of every instantiation (D 32, 64, 128), and no other kernel does."""
    import subprocess

    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run([f"{CUDA_HOME}/bin/cuobjdump", "-sass", str(_build.build())],
                          capture_output=True, text=True, check=True).stdout
    funcs = sass.split("Function : ")[1:]
    flash = ("flash_fwd_bf16", "flash_fwd_f32", "flash_bwd_bf16_main", "flash_bwd_f32_main")
    for kernel in flash:
        inst = [f for f in funcs if kernel in f.splitlines()[0]]
        assert len(inst) == 3, kernel          # D 32, 64, 128
        assert all("HGMMA" in f for f in inst), kernel
    assert not any("HGMMA" in f for f in funcs
                   if not any(kernel in f.splitlines()[0] for kernel in flash))


@pytest.mark.gpu
def test_f32_flash_backward_runs_on_the_tensor_cores_without_spilling(cuda):
    """The float32 backward's three instantiations (D 32, 64, 128) of its
    main kernel hold warpgroup MMAs (HGMMA) in their SASS, and ptxas reports
    no spill for any of its kernels: the products are on the tensor cores,
    and D 128 takes its tile products in halves to stay in 255 registers."""
    import subprocess

    from torch.utils.cpp_extension import CUDA_HOME

    lib = _build.build()
    sass = subprocess.run([f"{CUDA_HOME}/bin/cuobjdump", "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    main = [f for f in sass.split("Function : ")[1:]
            if "flash_bwd_f32_main" in f.splitlines()[0]]
    assert len(main) == 3
    assert all("HGMMA" in f for f in main)
    entry, spills = None, {}
    for line in (_build.BUILD_DIR / "ptxas.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1) if "flash_bwd_f32" in m.group(1) else None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if entry and m:
            spills[entry] = (int(m.group(1)), int(m.group(2)))
    assert len(spills) == 7          # main and prep at each D, one combine
    assert set(spills.values()) == {(0, 0)}, spills


def _check_f32_flash(q, k, v, causal):
    launches = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    assert out.dtype == torch.float32 and out.shape == q.shape
    torch.testing.assert_close(out, attention_ref(q, k, v, causal=causal),
                               **TOLS[torch.float32])


def _f32_qkv(cuda, seed, b, sq, sk, h, kv, d):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=cuda)
            for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d))]


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", FLASH_WIDE_CASES)
def test_flash_f32_kernel_matches_plain_on_wide_grids_on_card(cuda, b, sq, sk, h, kv, d,
                                                             causal):
    """The 3xTF32 kernel on grids several times wider than the card, at
    every head size, GQA, causal or Sq != Sk with ragged tails."""
    _check_f32_flash(*_f32_qkv(cuda, sq + d, b, sq, sk, h, kv, d), causal)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 127, 128, 129, 2500])
def test_flash_f32_kernel_at_tile_edges_on_card(cuda, s, causal):
    """Query and key counts on both sides of the 64-row query tile and the
    64-key kv tile, 16 query heads over 8 kv heads of 128."""
    _check_f32_flash(*_f32_qkv(cuda, s, 1, s, s, 16, 8, 128), causal)


@pytest.mark.gpu
def test_flash_f32_kernel_on_a_dit_band_on_card(cuda):
    """256 query rows of the Wan DiT's self-attention against all 18,900
    keys of its 40 heads of 128: the long rows where 3xTF32 has to hold."""
    _check_f32_flash(*_f32_qkv(cuda, 18900, 1, 256, 18900, 40, 40, 128), False)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_flash_f32_kernel_with_every_low_bit_set_on_card(cuda, causal):
    """q, k and v with all of their low 13 mantissa bits set: the kernel's
    lo = x - (x with those bits cleared) adds up with hi = x only if the
    tensor core drops those bits of hi (truncates); rounding them would put
    hi + lo a TF32 step (2^-10 of x) off, far past the limit."""
    q, k, v = (x.view(torch.int32).bitwise_or(0x1FFF).view(torch.float32)
               for x in _f32_qkv(cuda, 13, 1, 300, 300, 8, 4, 128))
    _check_f32_flash(q, k, v, causal)


def _cur(cur, cuda):
    return cur if isinstance(cur, int) else torch.tensor(cur, dtype=torch.int32,
                                                          device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq_axis", [1, 2])
@pytest.mark.parametrize("b,s,h,kv,d,cur", DECODE_CASES)
def test_decode_kernel_matches_plain_on_card(cuda, dtype, seq_axis, b, s, h, kv, d, cur):
    gen = torch.Generator(device=cuda).manual_seed(s)
    q = torch.randn(b, kv, h // kv, d, generator=gen, device=cuda).to(dtype)
    shape = (b, s, kv, d) if seq_axis == 1 else (b, kv, s, d)
    kc, vc = (torch.randn(shape, generator=gen, device=cuda).to(dtype) for _ in range(2))
    launches = K.decode_attention_grouped.launches
    out = K.decode_attention_grouped(q, kc, vc, _cur(cur, cuda), seq_axis=seq_axis)
    torch.cuda.synchronize()
    assert K.decode_attention_grouped.launches == launches + 1
    ref = K.decode_ref(q, kc, vc, _cur(cur, cuda), seq_axis=seq_axis)
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("seq_axis", [1, 2])
@pytest.mark.parametrize("b,s,h,kv,d,cur", DECODE_CASES)
def test_decode_int8_kernel_matches_plain_on_card(cuda, dtype, seq_axis, b, s, h, kv,
                                                  d, cur):
    gen = torch.Generator(device=cuda).manual_seed(s + 1)
    q = torch.randn(b, kv, h // kv, d, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(b, s, kv, d, generator=gen, device=cuda) for _ in range(2))
    (kq, ks), (vq, vs) = K.quantize_kv(k), K.quantize_kv(v)
    if seq_axis == 2:
        kq, vq = kq.transpose(1, 2).contiguous(), vq.transpose(1, 2).contiguous()
    launches = K.decode_attention_int8_grouped.launches
    out = K.decode_attention_int8_grouped(q, kq, vq, ks, vs, _cur(cur, cuda),
                                          seq_axis=seq_axis)
    torch.cuda.synchronize()
    assert K.decode_attention_int8_grouped.launches == launches + 1
    ref = K.decode_int8_ref(q, kq, vq, ks, vs, _cur(cur, cuda), seq_axis=seq_axis)
    torch.testing.assert_close(out.float(), ref.float(), **INT8_TOLS[dtype])


def _decode_case(cuda, seed, b, s, kv, g, d, seq_axis, cache_dtype, q_dtype):
    """q [B,KV,G,D] in q_dtype and the cache arguments of the kernel's
    wrapper: (k, v) in cache_dtype, or int8 (k, v, k_scale, v_scale)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(b, kv, g, d, generator=gen, device=cuda).to(q_dtype)
    k, v = (torch.randn(b, s, kv, d, generator=gen, device=cuda) for _ in range(2))
    if cache_dtype == torch.int8:
        (kq, ks), (vq, vs) = K.quantize_kv(k), K.quantize_kv(v)
        if seq_axis == 2:
            kq, vq = kq.transpose(1, 2).contiguous(), vq.transpose(1, 2).contiguous()
        return q, (kq, vq, ks, vs)
    k, v = k.to(cache_dtype), v.to(cache_dtype)
    if seq_axis == 2:
        k, v = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    return q, (k, v)


def _check_decode(q, cache, cur, seq_axis):
    """The kernel once (its counter risen by one) against its plain version."""
    int8 = cache[0].dtype == torch.int8
    kernel = K.decode_attention_int8_grouped if int8 else K.decode_attention_grouped
    plain = K.decode_int8_ref if int8 else K.decode_ref
    launches = kernel.launches
    out = kernel(q, *cache, cur, seq_axis=seq_axis)
    torch.cuda.synchronize()
    assert kernel.launches == launches + 1
    ref = plain(q, *cache, cur, seq_axis=seq_axis)
    tols = (INT8_TOLS if int8 else TOLS)[q.dtype]
    torch.testing.assert_close(out.float(), ref.float(), **tols)
    return out


#: (cache type, q type): the kernel's four instantiated pairs
DECODE_TYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                (torch.int8, torch.float32), (torch.int8, torch.bfloat16)]


def test_decode_chunk_matches_the_plain_rule():
    """The wrappers size the partials by the library's chunk; the CPU
    emulation (``decode_chunked_ref``) by ``chunk_len``.  Checked on the
    card, where the library builds; here the rule's served values."""
    assert (K.chunk_len(2, 128), K.chunk_len(1, 128), K.chunk_len(4, 128)) == (128, 256, 64)


@pytest.mark.gpu
def test_decode_chunk_of_the_library_equals_the_plain_rule(cuda):
    for elem in (1, 2, 4):
        for d in (32, 64, 128):
            assert _build.library().repro_decode_attention_chunk(elem, d) == \
                K.chunk_len(elem, d), (elem, d)


@pytest.mark.gpu
@pytest.mark.parametrize("seq_axis", [1, 2])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("cache_dtype,q_dtype", DECODE_TYPES)
def test_decode_kernel_at_chunk_edges_on_card(cuda, cache_dtype, q_dtype, d, seq_axis):
    """Rows whose last position is CHUNK - 1, CHUNK, CHUNK + 1 and S - 1
    (a ragged last chunk of 37 rows), at every head size and type pair."""
    chunk = K.chunk_len(cache_dtype.itemsize, d)
    s = 2 * chunk + 37
    q, cache = _decode_case(cuda, d + chunk, 4, s, 2, 2, d, seq_axis, cache_dtype,
                            q_dtype)
    cur = torch.tensor([chunk - 1, chunk, chunk + 1, s - 1], dtype=torch.int32,
                       device=cuda)
    _check_decode(q, cache, cur, seq_axis)


@pytest.mark.gpu
@pytest.mark.parametrize("seq_axis", [1, 2])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [97, 301, 603])
def test_decode_int8_kernel_with_unaligned_scales_on_card(cuda, s, q_dtype, seq_axis):
    """S not a multiple of 4: a row's scales [b, kv, :] start off the 16-byte
    grid for most (b, kv), so the kernel loads them by plain loads there and
    by bulk copy where aligned; no read past S."""
    q, cache = _decode_case(cuda, s, 3, s, 3, 4, 64, seq_axis, torch.int8, q_dtype)
    cur = torch.tensor([s - 1, s // 2, 0], dtype=torch.int32, device=cuda)
    _check_decode(q, cache, cur, seq_axis)


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.int8])
def test_decode_kernel_rows_do_not_depend_on_the_batch_on_card(cuda, cache_dtype):
    """Each row of a batch of 8, with 8 different indices, equals the same
    row decoded alone at B 1, bit for bit, at qwen3-1.7b's heads (KV 8, G 2,
    D 128) over a 1024-position cache: a served stream equals its solo
    generate only so."""
    q, cache = _decode_case(cuda, 11, 8, 1024, 8, 2, 128, 2, cache_dtype, torch.bfloat16)
    cur = [1023, 700, 511, 256, 255, 127, 1, 0]
    batch = _check_decode(q, cache, torch.tensor(cur, dtype=torch.int32, device=cuda), 2)
    for i, c in enumerate(cur):
        alone = _check_decode(q[i:i + 1].contiguous(),
                              tuple(x[i:i + 1].contiguous() for x in cache),
                              torch.tensor([c], dtype=torch.int32, device=cuda), 2)
        assert torch.equal(alone, batch[i:i + 1]), (i, c)


#: Served decode reads, [B,KV,S,D] caches: (B, KV, G, D, S, index; None = a
#: mixed index per row)
SERVED_DECODE_READS = [
    (8, 8, 2, 128, 1024, None),     # qwen3-1.7b's served cache
    (8, 32, 1, 64, 1024, None),     # zamba2-1.2b's shared block
    (4, 20, 1, 64, 1500, 1499),     # whisper-large-v3's cross cache at F - 1
    (4, 20, 1, 64, 448, 200),       # whisper-large-v3's self cache
]


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("b,kv,g,d,s,cur", SERVED_DECODE_READS)
def test_decode_combine_reads_the_partials_after_the_split_on_card(
        cuda, monkeypatch, cache_dtype, b, kv, g, d, s, cur):
    """The partials filled with NaN before every call: a combine that read
    them before the split kernel wrote them (without its
    ``griddepcontrol.wait``) would return NaN, where ``torch.empty`` could
    hand it the right values of the previous identical call.  Three calls in
    a row, each against its plain version."""
    from repro_torch.kernels.decode_attention import ops

    real = ops._partials

    def filled(q, cache, n):
        acc, ml = real(q, cache, n)
        acc.fill_(float("nan"))
        ml.fill_(float("nan"))
        return acc, ml

    monkeypatch.setattr(ops, "_partials", filled)
    q, cache = _decode_case(cuda, s + kv, b, s, kv, g, d, 2, cache_dtype, torch.bfloat16)
    idx = cur if cur is not None else torch.tensor(
        [s - 1, 700, 511, 256, 255, 1, 0, 64][:b], dtype=torch.int32, device=cuda)
    for _ in range(3):
        assert torch.isfinite(_check_decode(q, cache, idx, 2)).all()


@pytest.mark.gpu
def test_decode_kernels_copy_by_the_tma(cuda):
    """Every instantiation of the split kernel (3 head sizes x 4 type pairs
    x 2 group tiles) holds bulk copies (UBLKCP) in its SASS."""
    import subprocess

    from torch.utils.cpp_extension import CUDA_HOME

    sass = subprocess.run([f"{CUDA_HOME}/bin/cuobjdump", "-sass", str(_build.build())],
                          capture_output=True, text=True, check=True).stdout
    split = [f for f in sass.split("Function : ")[1:] if "decode_split" in f.splitlines()[0]]
    assert len(split) == 24
    assert all("UBLKCP" in f for f in split)


#: WKV6 y against its plain version, element by element:
#: |a - b| <= rtol |b| + WKV_ATOL_SHARE max|b|.  Kernel and plain version sum
#: y's 64 products r_k S_kv (terms up to ~10 here) in another order, and
#: float32 differences of that sum reach 1e-5 where y is near zero, so the
#: absolute part is scaled to the tensor's largest |y| (1e-5 of it) rather
#: than fixed.  rtol: float32 2e-5; bfloat16 one bfloat16 step, 2^-7 of the
#: value, since both round the same float32 y once.  The float32 state: 1e-4
#: absolute and relative, as the JAX package's WKV6 tests hold it.
WKV_RTOL = {torch.float32: 2e-5, torch.bfloat16: 2 ** -7}
WKV_ATOL_SHARE = 1e-5
WKV_STATE_TOL = dict(atol=1e-4, rtol=1e-4)


def wkv_inputs(gen, b, t, h, kk, dtype, nonzero_state, device):
    """Drawn as tests/test_kernels.py draws them: w = sigmoid(.) 0.5 + 0.45,
    k x 0.3, u x 0.1."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    r, k, v = randn(b, t, h, kk), randn(b, t, h, kk) * 0.3, randn(b, t, h, kk)
    w = torch.sigmoid(randn(b, t, h, kk)) * 0.5 + 0.45
    u = randn(h, kk) * 0.1
    s0 = randn(b, h, kk, kk) * 0.5 if nonzero_state else torch.zeros(
        b, h, kk, kk, device=device)
    return [x.to(dtype) for x in (r, k, v, w, u)] + [s0]


def assert_wkv_close(y, s, ref_y, ref_s, dtype):
    a, b = y.float(), ref_y.float()
    limit = WKV_RTOL[dtype] * b.abs() + WKV_ATOL_SHARE * b.abs().max()
    worst = float(((a - b).abs() / limit).max())
    assert worst <= 1.0, f"y differs: {worst:.3g} of the limit"
    torch.testing.assert_close(s, ref_s, **WKV_STATE_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("nonzero_state", [False, True])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("t", [1, 3, 64, 97, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kk,h", [(32, 8), (64, 4)])
def test_wkv6_kernel_matches_plain_on_card(cuda, kk, h, dtype, t, b, nonzero_state):
    gen = torch.Generator(device=cuda).manual_seed(t * 7 + b)
    xs = wkv_inputs(gen, b, t, h, kk, dtype, nonzero_state, cuda)
    launches = wkv6.launches
    y, s = wkv6(*xs)
    torch.cuda.synchronize()
    assert wkv6.launches == launches + 1
    assert y.dtype == dtype and s.dtype == torch.float32
    assert_wkv_close(y, s, *wkv6_ref(*xs), dtype)


def model_decays(gen, shape, device):
    """w as rwkv6 draws it (models/rwkv6.py): exp(-exp(x)) rounded to
    bfloat16, here for x uniform over [-6, 4] (down to e^-54.6), with 1 %
    exact zeros and 1 % exact ones planted."""
    x = torch.rand(shape, generator=gen, device=device) * 10 - 6
    w = torch.exp(-torch.exp(x)).bfloat16().float()
    pick = torch.rand(shape, generator=gen, device=device)
    return torch.where(pick < 0.01, 0., torch.where(pick > 0.99, 1., w))


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 97, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kk,h", [(32, 8), (64, 64)])
def test_wkv6_kernel_holds_model_decays_on_card(cuda, kk, h, dtype, t):
    """The decays the served model feeds the kernel: from near 1 down to
    e^-54.6 and exact zeros and ones, with a nonzero initial state.  A
    chunked form that divides by a decay, or takes its log unguarded, turns
    non-finite here and nowhere in the tests' [0.45, 0.95]."""
    gen = torch.Generator(device=cuda).manual_seed(t * 5 + kk)
    xs = wkv_inputs(gen, 1, t, h, kk, dtype, True, cuda)
    xs[3] = model_decays(gen, (1, t, h, kk), cuda).to(dtype)
    launches = wkv6.launches
    y, s = wkv6(*xs)
    torch.cuda.synchronize()
    assert wkv6.launches == launches + 1
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    assert_wkv_close(y, s, *wkv6_ref(*xs), dtype)


#: The WKV6 backward against ``wkv6_bwd_ref``, each output element by
#: element, as |a - b| <= rtol |b| + atol + share max|b| with (rtol, atol,
#: share): float32 (and dstate, float32 at either input type) within 2e-5
#: of the output's largest element, (0, 0, 2e-5), since both sum in float32
#: in another order; bfloat16 one bfloat16 step, (2^-7, 1e-5, 0), since both
#: round the same float32 gradient once.
WKV_BWD_TOL = {torch.float32: (0.0, 0.0, 2e-5), torch.bfloat16: (2 ** -7, 1e-5, 0.0)}
#: The reduced rwkv6's gradients, card against CPU, of each leaf's largest:
#: the forward kernel's chunked 3xTF32 sums and the backward's float32 sums
#: against the plain loops', through 2 layers and the cross entropy.
RWKV_GRAD_SHARE = 1e-4


def assert_wkv_grads_close(ours, ref, dtype):
    for name, a, b in zip(("dr", "dk", "dv", "dw", "du", "dstate"), ours, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        rtol, atol, share = WKV_BWD_TOL[torch.float32 if name == "dstate" else dtype]
        a, b = a.float(), b.float()
        limit = rtol * b.abs() + atol + share * b.abs().max()
        worst = float(((a - b).abs() / limit.clamp_min(1e-30)).max())  # 0 where both are
        assert bool(torch.isfinite(a).all()) and worst <= 1.0, \
            f"{name} differs: {worst:.3g} of the limit"


def wkv_bwd_inputs(gen, b, t, h, kk, dtype, nonzero, device):
    """`wkv_inputs`, each needing a gradient, with a random dy and, where
    ``nonzero``, a nonzero initial state and final-state gradient."""
    xs = wkv_inputs(gen, b, t, h, kk, dtype, nonzero, device)
    dy = torch.randn(b, t, h, kk, generator=gen, device=device).to(dtype)
    ds = torch.randn(b, h, kk, kk, generator=gen, device=device) if nonzero else None
    return xs, dy, ds


@pytest.mark.gpu
@pytest.mark.parametrize("nonzero", [False, True])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("t", [1, 15, 16, 97, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kk,h", [(32, 8), (64, 4)])
def test_wkv6_backward_matches_plain_on_card(cuda, kk, h, dtype, t, b, nonzero):
    """T of one step, under one chunk of 16, one whole chunk, ragged ends."""
    gen = torch.Generator(device=cuda).manual_seed(t * 11 + b)
    xs, dy, ds = wkv_bwd_inputs(gen, b, t, h, kk, dtype, nonzero, cuda)
    launches = wkv6_backward.launches
    ours = wkv6_backward(*xs, dy, ds)
    torch.cuda.synchronize()
    assert wkv6_backward.launches == launches + 1
    assert_wkv_grads_close(ours, wkv6_bwd_ref(*xs, dy, ds), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [97, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kk,h", [(32, 8), (64, 64)])
def test_wkv6_backward_holds_model_decays_on_card(cuda, kk, h, dtype, t):
    """The model's decays, exact zeros and ones among them: a backward that
    recovered S_{t-1} from S_t by dividing by w_t turns non-finite here."""
    gen = torch.Generator(device=cuda).manual_seed(t * 3 + kk)
    xs, dy, ds = wkv_bwd_inputs(gen, 1, t, h, kk, dtype, True, cuda)
    xs[3] = model_decays(gen, (1, t, h, kk), cuda).to(dtype)
    assert_wkv_grads_close(wkv6_backward(*xs, dy, ds), wkv6_bwd_ref(*xs, dy, ds), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_backward_gives_equal_bits_twice_on_card(cuda, dtype):
    """rwkv6-7b's heads at B 2, T 200: two calls, every output equal bit for
    bit (dv's row tiles and du's batch rows summed in a fixed order)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    xs, dy, ds = wkv_bwd_inputs(gen, 2, 200, 64, 64, dtype, True, cuda)
    first = wkv6_backward(*xs, dy, ds)
    second = wkv6_backward(*xs, dy, ds)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("state_grad", [False, True])
@pytest.mark.parametrize("use_state", [False, True])
def test_wkv6_differentiates_through_the_backward_kernel_on_card(cuda, state_grad, use_state):
    """autograd through ``wkv6`` on the card: one forward and one backward
    launch and exactly ``wkv6_backward``'s gradients; a final state the loss
    does not use has a zero gradient; the initial state gets one only where
    it asks for it."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    xs, dy, ds = wkv_bwd_inputs(gen, 2, 50, 4, 64, torch.bfloat16, True, cuda)
    leaves = [x.clone().requires_grad_(i < 5 or state_grad) for i, x in enumerate(xs)]
    fwd, bwd = wkv6.launches, wkv6_backward.launches
    y, s = wkv6(*leaves)
    loss = (y.float() * dy.float()).sum() + ((s * ds).sum() if use_state else 0)
    grads = torch.autograd.grad(loss, [x for x in leaves if x.requires_grad])
    torch.cuda.synchronize()
    assert (wkv6.launches, wkv6_backward.launches) == (fwd + 1, bwd + 1)
    want = wkv6_backward(*xs, dy, ds if use_state else None)
    assert len(grads) == (6 if state_grad else 5)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)
    with torch.no_grad():
        wkv6(*leaves)
    assert wkv6_backward.launches == bwd + 2


@pytest.mark.gpu
@pytest.mark.parametrize("d", [2048, 4096])
def test_norms_of_a_row_do_not_depend_on_the_batch_on_card(cuda, d):
    """A decode step norms each slot's row with the arithmetic it gets
    alone: the first b rows of a batch of 16 equal a batch of b, bit for
    bit, for every b, at qwen3-1.7b's and rwkv6-7b's widths.  The float32
    mean is where a plain ``mean(-1)`` differs (in about one draw of eight
    between 1 and 8 rows on an H100)."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    for _ in range(8):
        x = torch.randn(16, 1, d, generator=gen, device=cuda) * 3
        w = torch.randn(d, generator=gen, device=cuda) * 0.1
        means, normed = row_mean(x * x), rms_norm(x.bfloat16(), w.bfloat16())
        for b in range(1, 16):
            assert torch.equal(row_mean(x[:b] * x[:b]), means[:b]), b
            assert torch.equal(rms_norm(x[:b].bfloat16(), w.bfloat16()), normed[:b]), b


@pytest.mark.gpu
@pytest.mark.parametrize("n", [64, 160])
def test_skinny_decode_projection_rows_do_not_depend_on_the_batch_on_card(cuda, n):
    """rwkv6's decay and LoRA projections in a decode step: row 0 of a slot
    batch equals the row alone, bit for bit, at rwkv6-7b's widths."""
    gen = torch.Generator(device=cuda).manual_seed(n)
    w = (torch.randn(4096, n, generator=gen, device=cuda) / 64).bfloat16()
    for _ in range(8):
        x = torch.randn(20, 1, 5, 4096, generator=gen, device=cuda).bfloat16()[:, :, 3]
        full = L.row_blocks_matmul(x, w)
        for b in (1, 2, 8, 16):
            assert torch.equal(L.row_blocks_matmul(x[:b], w), full[:b]), b


#: chatglm3-6b's prefill heads (32 query heads over 2 kv heads of 128:
#: groups of 16) and gemma3-27b's global layers' (32 over 16) at the
#: smoke's served prompts
NEW_MODEL_PREFILLS = [
    # b, sq, sk, h, kv, d, causal
    (1, 512, 512, 32, 2, 128, True),
    (1, 1500, 1500, 32, 16, 128, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", NEW_MODEL_PREFILLS)
def test_flash_bf16_kernel_at_chatglm3_and_gemma3_heads_on_card(cuda, b, sq, sk, h,
                                                              kv, d, causal):
    _check_bf16_flash(*_bf16_qkv(cuda, sq + kv, b, sq, sk, h, kv, d), causal)


#: the prefill heads of internvl2-1b (14 over 2 of 64: groups of 7),
#: granite-moe-3b-a800m (24 over 8 of 64: groups of 3), deepseek-moe-16b
#: (16 over 16 of 128) and deepseek-67b (64 over 8 of 128) at a served
#: 512-token prompt
MOE_VLM_67B_PREFILLS = [
    # b, sq, sk, h, kv, d, causal
    (1, 512, 512, 14, 2, 64, True),
    (1, 512, 512, 24, 8, 64, True),
    (1, 512, 512, 16, 16, 128, True),
    (1, 512, 512, 64, 8, 128, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", MOE_VLM_67B_PREFILLS)
def test_flash_bf16_kernel_at_moe_vlm_and_67b_heads_on_card(cuda, b, sq, sk, h, kv, d,
                                                           causal):
    _check_bf16_flash(*_bf16_qkv(cuda, sq + h, b, sq, sk, h, kv, d), causal)


@pytest.mark.gpu
@pytest.mark.parametrize("e,d,f", [(64, 2048, 1408), (40, 1536, 512)])
def test_dropless_moe_rows_do_not_depend_on_the_batch_on_card(cuda, e, d, f):
    """The dropless MoE FFN in a decode step at deepseek-moe-16b's (64
    experts of 2048 x 1408, 2 shared, top-6) and granite-moe-3b-a800m's (40
    of 1536 x 512, top-8) widths: the first b rows of a slot batch of 8
    equal a batch of b, bit for bit."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.moe import moe_ffn_dense_fallback, moe_param_specs
    from repro_torch.models.param import init_tree

    arch = "deepseek-moe-16b" if e == 64 else "granite-moe-3b-a800m"
    cfg = get_config(arch)
    gen = torch.Generator(device=cuda).manual_seed(e)
    lp = {k: v[0] for k, v in init_tree(moe_param_specs(
        dataclasses.replace(cfg, d_model=d, d_ff=f), 1, "bfloat16"), gen, cuda).items()}
    for _ in range(2):
        x = torch.randn(8, 1, d, generator=gen, device=cuda).bfloat16()
        full, _ = moe_ffn_dense_fallback(x, lp, cfg)
        assert torch.isfinite(full.float()).all()
        for b in (1, 2, 4):
            assert torch.equal(moe_ffn_dense_fallback(x[:b], lp, cfg)[0], full[:b]), b


@pytest.mark.gpu
@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.int8])
def test_decode_kernel_at_groups_of_16_on_card(cuda, cache_dtype):
    """chatglm3-6b's decode: B 8, KV 2, G 16, D 128 over a served 1024
    positions, a mixed per-row index, the bfloat16 and the int8 cache."""
    q, cache = _decode_case(cuda, 16, 8, 1024, 2, 16, 128, 2, cache_dtype,
                            torch.bfloat16)
    cur = torch.tensor([1023, 700, 511, 256, 255, 127, 1, 0], dtype=torch.int32,
                       device=cuda)
    _check_decode(q, cache, cur, 2)


#: a ring of 1024 slots (gemma3-27b's local layers), rows before, at and
#: after the first wrap, and far past it
RING_CUR = [0, 1, 511, 1022, 1023, 1024, 1500, 3000]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_decode_through_the_kernel_on_card(cuda, dtype):
    """A local layer's decode: flash-decode over the ring at min(cur, 1023)
    against ``attention_decode_ring``'s plain version at cur (in float32 on
    the same numbers, rounded to the output's type), at gemma3-27b's heads
    (B 8, KV 16, G 2, D 128)."""
    gen = torch.Generator(device=cuda).manual_seed(1024)
    q = torch.randn(8, 32, 128, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(8, 16, 1024, 128, generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    cur = torch.tensor(RING_CUR, dtype=torch.int32, device=cuda)
    launches = K.decode_attention_grouped.launches
    out = L.attention_decode(q, k, v, cur.clamp(max=1023))
    torch.cuda.synchronize()
    assert K.decode_attention_grouped.launches == launches + 1
    ref = L.attention_decode_ring(q.float(), k.float(), v.float(), cur).to(dtype)
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("d_in,d_out", [(4096, 4096), (4096, 256), (4096, 13696),
                                        (13696, 4096), (4096, 65024), (5376, 4096),
                                        (5376, 2048), (4096, 5376), (5376, 21504),
                                        (21504, 5376), (5376, 262144),
                                        (8192, 8192), (8192, 1024), (8192, 22016),
                                        (22016, 8192), (8192, 102400), (896, 896),
                                        (896, 128), (896, 4864), (4864, 896),
                                        (896, 151808), (1536, 1536), (1536, 512),
                                        (1536, 49408), (2048, 11264), (11264, 2048),
                                        (2048, 102400)])
def test_decode_projection_rows_do_not_depend_on_the_batch_on_card(cuda, d_in, d_out):
    """A decode step's bfloat16 projections at chatglm3-6b's, gemma3-27b's,
    deepseek-67b's, internvl2-1b's, granite-moe-3b-a800m's and
    deepseek-moe-16b's widths: the first b rows of a slot batch of 8 equal a
    batch of b, bit for bit, so a served stream can equal its solo
    generate."""
    gen = torch.Generator(device=cuda).manual_seed(d_in + d_out)
    w = (torch.randn(d_in, d_out, generator=gen, device=cuda) / d_in ** 0.5).bfloat16()
    for _ in range(4):
        x = torch.randn(8, 1, d_in, generator=gen, device=cuda).bfloat16()
        full = x @ w
        for b in (1, 2, 4):
            assert torch.equal(x[:b] @ w, full[:b]), b


@pytest.mark.gpu
def test_vae_conv_does_not_depend_on_free_memory_on_card(cuda):
    """The Wan VAE's widest decoder convolution (192 to 96 channels at
    480x480) on a batch of 4 gives the same numbers with 3 GB free as with
    the card empty: cuDNN's FFT algorithms would ask for more workspace than
    that and fall back to another algorithm; the VAE runs without cuDNN."""
    from repro_torch.models.aigc.vae import _conv

    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(4, 192, 480, 480, generator=gen, device=cuda)
    w = torch.randn(96, 192, 3, 3, generator=gen, device=cuda) / 1728 ** 0.5
    ref = _conv(x, w)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    hog = torch.empty(max(free - (3 << 30), 0), dtype=torch.uint8, device=cuda)
    try:
        assert torch.equal(_conv(x, w), ref)
    finally:
        del hog


#: The backward kernel's cases: every head size, causal and not, GQA,
#: Sq != Sk, ragged tiles, grids wider than the card, the smoke's four
#: (qwen3-1.7b's training layer, zamba2-1.2b's shared block, whisper's
#: cross-attention, a band of the Wan DiT), two whose bfloat16 dq splits
#: the key range (13 and 24 parts, the last key tile ragged), and a long
#: causal one whose dK/dV sum over 128 query tiles.
FLASH_BWD_CASES = [
    # b, sq, sk, h, kv, d, causal
    (1, 64, 64, 2, 2, 32, False),
    (2, 70, 70, 4, 2, 32, True),
    (2, 33, 97, 6, 2, 64, False),
    (1, 150, 150, 4, 1, 128, True),
    (1, 300, 200, 8, 8, 128, False),
    (2, 129, 129, 12, 4, 64, True),
    (4, 256, 256, 16, 8, 128, True),
    (1, 512, 512, 32, 32, 64, True),
    (1, 64, 1500, 20, 20, 64, False),
    (1, 2048, 2048, 40, 40, 128, False),
    (2, 64, 1537, 4, 4, 128, False),
    (1, 17, 3000, 8, 2, 64, False),
    (1, 4096, 4096, 16, 8, 128, True),
]


def _flash_bwd_inputs(cuda, seed, b, sq, sk, h, kv, d, causal, dtype):
    """q, k, v, o, do and the log-sum-exp that the forward kernel stores."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q, do = (torch.randn(b, sq, h, d, generator=gen, device=cuda).to(dtype) for _ in range(2))
    k, v = (torch.randn(b, sk, kv, d, generator=gen, device=cuda).to(dtype) for _ in range(2))
    o, lse = flash_attention_with_lse(q, k, v, causal=causal)
    return q, k, v, o, do, lse


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", FLASH_BWD_CASES)
def test_flash_backward_kernel_matches_plain_on_card(cuda, dtype, b, sq, sk, h, kv, d, causal):
    """dq, dk, dv of the backward kernel against ``attention_bwd_ref`` on the
    same inputs (the forward kernel's o): float32 to 2e-5, bfloat16 within
    one bfloat16 step, element by element; both from the forward's
    log-sum-exp, the plain version recomputing the softmax."""
    q, k, v, o, do, lse = _flash_bwd_inputs(cuda, b * sq + d, b, sq, sk, h, kv, d, causal,
                                            dtype)
    launches = flash_attention_backward.launches
    ours = flash_attention_backward(q, k, v, o, do, causal=causal, lse=lse)
    torch.cuda.synchronize()
    assert flash_attention_backward.launches == launches + 1
    ref = attention_bwd_ref(q, k, v, o, do, causal=causal)
    for name, a, r in zip(("dq", "dk", "dv"), ours, ref):
        assert a.dtype == dtype and a.shape == r.shape, name
        torch.testing.assert_close(a.float(), r.float(), **TOLS[dtype], msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", [
    (2, 256, 256, 16, 8, 128, True),
    (1, 17, 3000, 8, 2, 64, False),   # dq split in 24 parts
])
def test_flash_backward_kernel_is_deterministic_on_card(cuda, dtype, b, sq, sk, h, kv, d,
                                                        causal):
    q, k, v, o, do, lse = _flash_bwd_inputs(cuda, 7, b, sq, sk, h, kv, d, causal, dtype)
    first = flash_attention_backward(q, k, v, o, do, causal=causal, lse=lse)
    for _ in range(3):
        again = flash_attention_backward(q, k, v, o, do, causal=causal, lse=lse)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_f32_flash_backward_with_every_low_bit_set_on_card(cuda, causal):
    """q, k, v, o and dO with all of their low 13 mantissa bits set: the
    backward's lo = x - (x with those bits cleared) adds up with hi = x only
    if the tensor core drops those bits of hi, as the forward's test holds
    it; P and dS are split in registers the same way."""
    q, k, v, o, do, _ = _flash_bwd_inputs(cuda, 13, 1, 300, 300, 8, 4, 128, causal,
                                          torch.float32)
    q, k, v, do = (x.view(torch.int32).bitwise_or(0x1FFF).view(torch.float32)
                   for x in (q, k, v, do))
    o, lse = flash_attention_with_lse(q, k, v, causal=causal)
    ours = flash_attention_backward(q, k, v, o, do, causal=causal, lse=lse)
    torch.cuda.synchronize()
    for name, a, r in zip(("dq", "dk", "dv"), ours,
                          attention_bwd_ref(q, k, v, o, do, causal=causal)):
        torch.testing.assert_close(a, r, **TOLS[torch.float32], msg=name)


@pytest.mark.gpu
def test_f32_flash_backward_needs_the_forwards_lse_on_card(cuda):
    q, k, v, o, do, lse = _flash_bwd_inputs(cuda, 5, 1, 64, 64, 2, 2, 64, True,
                                            torch.float32)
    launches = flash_attention_backward.launches
    with pytest.raises(ValueError, match="log-sum-exp"):
        flash_attention_backward(q, k, v, o, do, causal=True)
    with pytest.raises(ValueError, match="log-sum-exp"):
        flash_attention_backward(q, k, v, o, do, causal=True, lse=lse[:, :, :32])
    assert flash_attention_backward.launches == launches


@pytest.mark.gpu
def test_bf16_flash_backward_needs_the_forwards_lse_on_card(cuda):
    q, k, v, o, do, lse = _flash_bwd_inputs(cuda, 5, 1, 64, 64, 2, 2, 64, True,
                                            torch.bfloat16)
    launches = flash_attention_backward.launches
    with pytest.raises(ValueError, match="log-sum-exp"):
        flash_attention_backward(q, k, v, o, do, causal=True)
    with pytest.raises(ValueError, match="log-sum-exp"):
        flash_attention_backward(q, k, v, o, do, causal=True, lse=lse[:, :, :32])
    assert flash_attention_backward.launches == launches


@pytest.mark.gpu
def test_flash_attention_with_lse_refuses_a_gradient_on_card(cuda):
    """Under grad mode ``flash_attention_with_lse`` refuses inputs that need
    a gradient before it launches (its o has no ``grad_fn``); without grad
    it launches once."""
    q, k, v = (torch.randn(1, 64, 2, 64, device=cuda).bfloat16().requires_grad_()
               for _ in range(3))
    launches = flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward kernel"):
        flash_attention_with_lse(q, k, v, causal=True)
    assert flash_attention.launches == launches
    with torch.no_grad():
        o, lse = flash_attention_with_lse(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    assert o.grad_fn is None and lse.shape == (1, 2, 64)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", FLASH_CASES + [(4, 256, 256, 16, 8, 128, True)])
def test_bf16_forward_stores_the_lse_without_changing_o_on_card(cuda, b, sq, sk, h, kv, d,
                                                                causal):
    """The bfloat16 forward with the log-sum-exp buffer writes the same bits
    of o as without it (serving passes none), one launch each, and its
    log-sum-exp matches the plain version's to float32 2e-5."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
               .bfloat16() for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))
    launches = flash_attention.launches
    with torch.no_grad():
        plain_o = flash_attention(q, k, v, causal=causal)
    o, lse = flash_attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 2
    assert torch.equal(o, plain_o)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    _, ref = attention_ref(q, k, v, causal=causal, return_lse=True)
    torch.testing.assert_close(lse, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", FLASH_CASES + [(4, 256, 256, 8, 4, 64, True)])
def test_f32_forward_stores_the_lse_without_changing_o_on_card(cuda, b, sq, sk, h, kv, d,
                                                               causal):
    """The float32 forward with the log-sum-exp buffer writes the same bits
    of o as without it (serving passes none), one launch each, and its
    log-sum-exp matches the plain version's to float32 2e-5; the last case
    is the launcher's float32 ``100m`` preset."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
               for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))
    launches = flash_attention.launches
    with torch.no_grad():
        plain_o = flash_attention(q, k, v, causal=causal)
    o, lse = flash_attention_with_lse(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 2
    assert torch.equal(o, plain_o)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    _, ref = attention_ref(q, k, v, causal=causal, return_lse=True)
    torch.testing.assert_close(lse, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_differentiates_through_the_backward_kernel_on_card(cuda, dtype):
    """autograd through ``flash_attention`` on the card: one forward launch,
    one backward launch, and exactly the backward kernel's gradients (from
    the log-sum-exp the forward stored)."""
    q, k, v, o, do, lse = _flash_bwd_inputs(cuda, 11, 2, 100, 100, 8, 2, 64, True, dtype)
    qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
    fwd, bwd = flash_attention.launches, flash_attention_backward.launches
    out = flash_attention(qq, kk, vv, causal=True)
    grads = torch.autograd.grad(out, (qq, kk, vv), do)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_backward.launches) == (fwd + 1, bwd + 1)
    assert torch.equal(out, o)
    for a, b in zip(grads, flash_attention_backward(q, k, v, o, do, causal=True, lse=lse)):
        assert torch.equal(a, b)


def _decode_call(cuda, rg):
    q = torch.randn(2, 2, 2, 64, device=cuda, requires_grad=rg)
    kc = torch.randn(2, 2, 32, 64, device=cuda)
    return lambda: K.decode_attention_grouped(q, kc, kc, 5)


def _decode_int8_call(cuda, rg):
    q = torch.randn(2, 2, 2, 64, device=cuda, requires_grad=rg)
    kc = torch.zeros(2, 2, 32, 64, dtype=torch.int8, device=cuda)
    sc = torch.ones(2, 2, 32, device=cuda)
    return lambda: K.decode_attention_int8_grouped(q, kc, kc, sc, sc, 5)


def _ddim_call(cuda, rg):
    x = torch.randn(100, device=cuda, requires_grad=rg)
    return lambda: ddim_step(x, torch.randn(100, device=cuda), 0.5, 0.6)


@pytest.mark.gpu
@pytest.mark.parametrize("make", [_decode_call, _decode_int8_call, _ddim_call])
def test_kernels_without_a_backward_refuse_a_gradient_on_card(cuda, make):
    """Under grad mode an input that needs a gradient makes the wrapper
    raise, naming the missing backward, rather than return a result that
    drops the gradient; without grad (serving) or without such an input it
    launches."""
    with pytest.raises(RuntimeError, match="no backward kernel"):
        make(cuda, True)()
    with torch.no_grad():
        make(cuda, True)()
    make(cuda, False)()
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_rwkv6_loss_gradients_on_the_card_match_the_cpu(cuda):
    """Reduced rwkv6 (2 layers of 8 heads of 32) in float32: one loss and
    gradient of ``registry.loss_fn`` on the card, through the WKV6 forward
    and backward kernels (2 forward and 1 backward launches a layer: each
    layer's forward is recomputed under checkpointing), against the same on
    the CPU (autograd of the plain loop) from the same weights and batch:
    the loss to 1e-5 and every leaf to RWKV_GRAD_SHARE of its largest."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.convert import to_port_layout
    from repro_torch.models import registry
    from repro_torch.models.param import tree_leaves, tree_map
    from repro_torch.training.train_step import init_params, trainable

    cfg = dataclasses.replace(get_config("rwkv6-7b").reduced(), dtype="float32")
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = trainable(tree_map(lambda p: p.detach().to(cuda), cpu))
    tok = torch.randint(0, cfg.vocab_size, (2, 2, 70), generator=torch.Generator().manual_seed(1))

    def loss_and_grads(params, dev):
        batch = {"tokens": tok[0].to(dev), "labels": tok[1].to(dev)}
        loss, _ = registry.loss_fn(to_port_layout(params), batch, cfg)
        return loss, torch.autograd.grad(loss, tree_leaves(params))

    fwd, bwd = wkv6.launches, wkv6_backward.launches
    loss_card, grads_card = loss_and_grads(card, cuda)
    torch.cuda.synchronize()
    assert (wkv6.launches - fwd, wkv6_backward.launches - bwd) == (2 * cfg.num_layers,
                                                                   cfg.num_layers)
    loss_cpu, grads_cpu = loss_and_grads(cpu, "cpu")
    torch.testing.assert_close(loss_card.cpu(), loss_cpu, atol=0, rtol=1e-5)
    for a, b in zip(grads_card, grads_cpu):
        assert bool(torch.isfinite(a).all())
        assert float((a.cpu() - b).abs().max()) <= RWKV_GRAD_SHARE * float(b.abs().max())


@pytest.mark.gpu
def test_two_training_steps_from_one_start_give_equal_weights_on_card(cuda):
    """One AdamW step of reduced qwen3 in bfloat16 (the flash forward and
    backward kernels in both of its layers), twice from the same weights
    and batch: every leaf equal bit for bit, the backward having no
    atomics."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.param import tree_leaves
    from repro_torch.training import adamw_init, make_train_step
    from repro_torch.training.train_step import init_params

    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(), dtype="bfloat16")
    tok = torch.randint(0, cfg.vocab_size, (2, 2, 128),
                        generator=torch.Generator().manual_seed(1)).to(cuda)
    runs = []
    for _ in range(2):
        params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
        bwd = flash_attention_backward.launches
        params, _, m = make_train_step(cfg, lr=1e-3)(params, adamw_init(params),
                                                      {"tokens": tok[0], "labels": tok[1]})
        torch.cuda.synchronize()
        assert flash_attention_backward.launches == bwd + cfg.num_layers
        assert torch.isfinite(m["loss"])
        runs.append([p.detach().clone() for p in tree_leaves(params)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_adamw_update_of_a_large_leaf_keeps_its_temporaries_small(cuda):
    """One ``adamw_update`` of a bfloat16 leaf of 2^28 elements (512 MiB;
    its float32 copy is 1 GiB): the peak above the leaf, its gradient and
    its two moments stays under 2 GiB, and the moments and the leaf move."""
    from repro_torch.training import adamw_init, adamw_update

    gen = torch.Generator(device=cuda).manual_seed(0)
    n = 1 << 28
    params = {"w": torch.randn(n, generator=gen, device=cuda).to(torch.bfloat16)}
    grads = {"w": torch.randn(n, generator=gen, device=cuda).to(torch.bfloat16)}
    before = params["w"].clone()
    state = adamw_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    params, state, gnorm = adamw_update(grads, state, params, lr=1e-3)
    torch.cuda.synchronize()
    above = torch.cuda.max_memory_allocated() - held
    assert above < 2 * 2 ** 30, f"{above / 2 ** 30:.2f} GiB above the leaf and its state"
    assert bool(torch.isfinite(gnorm)) and float(gnorm) > 1.0
    assert float(state.mu["w"].abs().max()) > 0 and float(state.nu["w"].abs().max()) > 0
    assert not torch.equal(params["w"], before)

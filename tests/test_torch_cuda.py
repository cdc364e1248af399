"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  These tests need a CUDA device and ``nvcc`` and skip elsewhere;
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

from repro_torch.kernels import _build, ddim_step, flash_attention
from repro_torch.kernels.ddim_step import ddim_coefs, ddim_step_ref
from repro_torch.kernels.flash_attention import attention_ref
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


def test_every_binding_has_a_c_entry_point():
    sources = {p.name for p in _build.sources()}
    assert sources == {"flash_attention.cu", "ddim_step.cu", "runtime.cu"}
    text = "".join(p.read_text() for p in _build.sources())
    entries = set(re.findall(r'extern "C" [\w\s*]+?\b(repro_\w+)\(', text))
    assert entries == set(_build.SIGNATURES)


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

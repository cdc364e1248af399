"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
nothing of ``jax`` or of the JAX package ``repro``, and its entry points run
on CUDA unless the caller asks for the CPU — without a card they raise
instead of carrying on quietly on the CPU.
"""
from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def port_modules():
    return sorted(
        ".".join(p.relative_to(PKG.parent).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def imported_roots(path: pathlib.Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    mods = port_modules()
    for m in ("repro_torch.kernels.flash_attention.ops",
              "repro_torch.kernels.decode_attention.ops",
              "repro_torch.kernels.rwkv6_wkv.ops",
              "repro_torch.models.transformer", "repro_torch.models.rwkv6",
              "repro_torch.models.encdec", "repro_torch.models.mamba2",
              "repro_torch.serving.disagg", "repro_torch.serving.engine",
              "repro_torch.configs.qwen3_1p7b", "repro_torch.configs.rwkv6_7b"):
        assert m in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**env, "PYTHONPATH": str(PKG.parent)},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_repro(path):
    assert path.exists(), path
    assert not imported_roots(path) & set(FORBIDDEN)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_pipeline_without_a_device_raises_without_cuda(no_cuda):
    from repro_torch.configs.wan_i2v import SMALL
    from repro_torch.models.aigc import WanI2VPipeline

    with pytest.raises(RuntimeError, match="no CUDA device"):
        WanI2VPipeline()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WanI2VPipeline(cfg=SMALL, device="cuda")
    assert WanI2VPipeline(cfg=SMALL, device="cpu").device.type == "cpu"


def test_weight_bridge_without_a_device_raises_without_cuda(no_cuda):
    from repro_torch.convert import params_from_numpy

    tree = {"w": np.zeros((2, 2), np.float32)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(tree)
    assert params_from_numpy(tree, device="cpu")["w"].device.type == "cpu"


def test_serve_launcher_without_a_device_raises_without_cuda(no_cuda, monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--profile", "small"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main()


def test_serving_engine_without_a_device_raises_without_cuda(no_cuda):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serving import ServingEngine

    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(), dtype="float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, max_len=16, device="cuda")
    assert ServingEngine(cfg, max_len=16, device="cpu").device.type == "cpu"


def test_llm_serve_launcher_without_a_device_raises_without_cuda(no_cuda, monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(sys, "argv", ["serve", "--workflow", "llm",
                                      "--profile", "small"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main()


def test_chip_smoke_refuses_without_cuda():
    """Run without a card, the smoke exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

"""``chip_smoke.train_attention_calls`` held to the flash attention calls
that one training loss and its backward make, counted on the CPU.

On the card ``chip_smoke.py`` checks every training run and gradient check
against that helper's count of forward and backward flash launches (each
family's layers run under ``torch.utils.checkpoint``, so a checkpointed
attention runs its forward twice).  Here the wrapper's forward and backward
(``ops._forward`` and ``ops._backward``, where the card's counters rise)
are wrapped in the test to count their calls, while ``registry.loss_fn`` of
each family's reduced float32 config, or Wan's ``diffusion_loss`` at
``SMALL``, runs forward and backward through the plain versions.
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.wan_i2v import SMALL
from repro_torch.convert import to_port_layout
from repro_torch.device import generator
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import registry
from repro_torch.models.aigc import dit
from repro_torch.models.param import init_tree, tree_leaves
from repro_torch.training.train_step import init_params, trainable

#: Small shapes gain nothing from many intra-op threads; the suite's other
#: workers (some timing-sensitive) share the machine's cores.
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
B, S = 2, 16


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


train_attention_calls = _chip_smoke().train_attention_calls

#: arch -> overrides of its reduced float32 config: each family and the
#: structure that decides its count.  gemma3 at 5 layers of period (1, 1)
#: with a window of 8 (two periods of a local and a global layer, then a
#: local tail layer; local layers are plain PyTorch); zamba2 at 5 layers of
#: period 2 (the shared block at 2 places, a tail layer); whisper at 2
#: encoder and 3 decoder layers; deepseek-moe keeps its leading dense layer;
#: deepseek-67b at 3 layers.
FAMILIES = {
    "qwen3-1.7b": {},
    "chatglm3-6b": {},
    "gemma3-27b": dict(num_layers=5, local_global_pattern=(1, 1), sliding_window=8),
    "internvl2-1b": {},
    "granite-moe-3b-a800m": {},
    "deepseek-moe-16b": {},
    "deepseek-67b": dict(num_layers=3),
    "rwkv6-7b": {},
    "zamba2-1.2b": dict(num_layers=5),
    "whisper-large-v3": dict(num_layers=3),
}


@pytest.fixture
def counted(monkeypatch):
    """The flash wrapper's forward and backward, each call counted."""
    calls = {"forward": 0, "backward": 0}
    real = ops._forward, ops._backward

    def forward(*a, **kw):
        calls["forward"] += 1
        return real[0](*a, **kw)

    def backward(*a, **kw):
        calls["backward"] += 1
        return real[1](*a, **kw)

    monkeypatch.setattr(ops, "_forward", forward)
    monkeypatch.setattr(ops, "_backward", backward)
    return calls


def _batch(cfg, rng):
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, min(cfg.frontend_tokens, S), cfg.d_model)).astype(np.float32))
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_train_attention_calls_counts_a_loss_and_its_backward(arch, counted):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32", **FAMILIES[arch])
    params = init_params(cfg, generator(0, "cpu"), "cpu")
    loss, _ = registry.loss_fn(to_port_layout(params), _batch(cfg, np.random.default_rng(0)),
                               cfg, dropless=cfg.num_experts > 0)
    grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True)
    assert all(g is None or torch.isfinite(g).all() for g in grads)
    want = train_attention_calls(cfg)
    assert (counted["forward"], counted["backward"]) == want
    assert (want == (0, 0)) == (cfg.family == "ssm")


def test_train_attention_calls_counts_diffusion_loss(counted):
    params = trainable(init_tree(dit.abstract_params(SMALL), generator(0, "cpu"), "cpu"))
    gen = generator(1, "cpu")
    pd = SMALL.patch ** 2 * SMALL.vae_latent_ch
    z = torch.randn((B, SMALL.video_tokens, pd), generator=gen)
    text = torch.randn((B, SMALL.text_len, SMALL.text_d_model), generator=gen)
    loss = dit.diffusion_loss(to_port_layout(params), z, text, SMALL, generator=gen)
    torch.autograd.grad(loss, tree_leaves(params))
    assert (counted["forward"], counted["backward"]) == train_attention_calls(SMALL) == (4, 4)

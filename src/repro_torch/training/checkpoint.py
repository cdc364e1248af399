"""Minimal checkpointing: a flat-key npz of the parameters and the optimizer
state, in the JAX package's layout (``src/repro/training/checkpoint.py``):
``__step__``, ``p/<path>`` for each parameter and ``o/<path>`` for each
leaf of the optimizer state, the path joined with ``/`` over dict keys
(sorted) and sequence indices, as ``jax.tree_util`` names them.  The JAX
optimizer state is a named tuple, whose fields it names ``.step``, ``.mu``
and ``.nu``: its leaves are ``o/.step``, ``o/.mu/<path>`` and
``o/.nu/<path>``.  A file either package saved loads into the other.

The trees are the training path's (the JAX layout: stacked ``[L, ...]``
leaves, as ``convert.tensors_from_numpy`` makes them), so nothing is mapped.
"""
from __future__ import annotations

import pathlib
from typing import Dict

import numpy as np
import torch

from repro_torch.models.param import tree_unflatten
from repro_torch.training.optimizer import AdamWState


def _flatten(tree, prefix: str = "") -> Dict[str, object]:
    """Path -> leaf, in ``jax.tree`` flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _opt_tree(opt: AdamWState):
    return {".step": np.asarray(opt.step, np.int32), ".mu": opt.mu, ".nu": opt.nu}


def save_checkpoint(path: str, params, opt_state: AdamWState = None, step: int = 0) -> None:
    """bfloat16 leaves are stored as float32 (numpy has no bfloat16)."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    blobs = {"__step__": np.asarray(step)}
    for k, v in _flatten(params).items():
        blobs[f"p/{k}"] = _numpy(v)
    if opt_state is not None:
        for k, v in _flatten(_opt_tree(opt_state)).items():
            blobs[f"o/{k}"] = _numpy(v)
    np.savez(p, **blobs)


def load_checkpoint(path: str, params_template, opt_template: AdamWState = None):
    """Restores into the given trees' structure, each leaf in its template's
    type and on its device; -> (params, opt, step)."""
    z = np.load(path, allow_pickle=False)
    step = int(z["__step__"])

    def restore(template, prefix):
        leaves = []
        for key, leaf in _flatten(template).items():
            arr = torch.from_numpy(np.asarray(z[f"{prefix}/{key}"]))
            if isinstance(leaf, torch.Tensor):
                arr = arr.to(device=leaf.device, dtype=leaf.dtype)
            leaves.append(arr)
        return tree_unflatten(template, leaves)

    params = restore(params_template, "p")
    opt = None
    if opt_template is not None:
        o = restore(_opt_tree(opt_template), "o")
        opt = AdamWState(step=int(o[".step"]), mu=o[".mu"], nu=o[".nu"])
    return params, opt, step

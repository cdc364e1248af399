"""The weight bridge between the JAX package's parameter layout and the
port's.

The JAX pipeline keeps each model's layers stacked along a leading ``[nl]``
axis (for ``lax.scan``) and its convolutions in HWIO.  The port loops over a
list of per-layer dicts and convolves in NCHW with OIHW weights.  This is
the one place where a layout changes:

* a ``layers`` subtree of stacked ``[nl, ...]`` leaves becomes a list of
  ``nl`` dicts of per-layer views (the Wan stages and the language models
  alike: ``models/transformer.py`` loops over that list, and its layer i
  reads views into the stacked tensors, so nothing is copied; the views are
  one ``unbind`` of each leaf, whose gradient is one stack of the layers'
  gradients into the leaf's shape when the training path differentiates
  through them), and so do
  a ``dense0`` subtree (deepseek-moe's leading dense layers) and the
  ``encoder`` / ``decoder`` layer stacks of the encoder-decoder (whisper's,
  told apart by their ``norm`` leaf);
* every leaf under the VAE's ``encoder`` / ``decoder`` (convs) goes from
  HWIO to OIHW.

Everything else keeps its shape, so the same matmuls run on the same
numbers.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

Tree = Dict[str, Any]


def _is_layer_stack(key: str, val) -> bool:
    return key in ("layers", "dense0") or (key in ("encoder", "decoder")
                                            and "norm" in val)


def to_port_layout(tree: Tree) -> Tree:
    """A parameter tree of tensors in the JAX layout -> the port's layout."""
    out: Tree = {}
    for key, val in tree.items():
        if _is_layer_stack(key, val):
            per_layer = {name: leaf.unbind(0) for name, leaf in val.items()}
            n = len(next(iter(per_layer.values())))
            out[key] = [{name: views[i] for name, views in per_layer.items()}
                        for i in range(n)]
        elif key in ("encoder", "decoder"):
            out[key] = {name: w.permute(3, 2, 0, 1).contiguous()
                        for name, w in val.items()}
        elif isinstance(val, dict):
            out[key] = to_port_layout(val)
        else:
            out[key] = val
    return out


def _to_torch(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree)).to(device)


def tensors_from_numpy(tree: Tree, device: DeviceLike = None) -> Tree:
    """A JAX parameter tree of numpy arrays -> the same tree of tensors on
    ``device`` (``cuda`` unless the caller names another), layout unchanged:
    the training path's tree, whose stacked leaves the optimizer updates and
    the checkpoint stores (``to_port_layout`` views them per layer)."""
    return _to_torch(tree, resolve_device(device))


def params_from_numpy(tree: Tree, device: DeviceLike = None) -> Tree:
    """A JAX parameter tree (one of the Wan pipeline's ``text_params`` /
    ``vae_params`` / ``dit_params``, or a language model's
    ``abstract_params`` tree), as nested dicts of numpy arrays, -> the
    port's tree of tensors on ``device`` (``cuda`` unless the caller names
    another)."""
    return to_port_layout(tensors_from_numpy(tree, device))

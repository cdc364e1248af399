"""Train step factory: loss, gradients and AdamW, uniform over all families
(the JAX package's ``src/repro/training/train_step.py``).

The parameters are the training tree: the JAX layout (stacked ``[L, ...]``
leaves), each leaf a tensor that requires grad (``trainable``).  A step
views the tree in the port's layout (``convert.to_port_layout``: one
``unbind`` of each stacked leaf, so a layer reads views) for
``registry.loss_fn`` and takes the gradients of the stacked leaves; the
optimizer and the checkpoint work on the same tree.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import to_port_layout
from repro_torch.models import registry
from repro_torch.models.param import (
    init_tree,
    is_dtensor,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from repro_torch.training.optimizer import AdamWState, adamw_update


def trainable(params):
    """The tree with every floating leaf set to require grad (in place)."""
    return tree_map(lambda p: p.requires_grad_() if p.is_floating_point() else p, params)


def init_params(cfg: ModelConfig, generator: torch.Generator, device) -> Dict[str, Any]:
    """Random weights by the JAX init rules, in the training tree's layout."""
    return trainable(init_tree(registry.abstract_params(cfg), generator, device))


def _split_shards(x, n: int) -> list:
    """A batch-sharded DTensor cut into ``n`` microbatches, each rank's
    shard into n pieces: microbatch i holds piece i of every shard (on one
    device, rows i B/n .. (i + 1) B/n, as a plain batch splits)."""
    from torch.distributed.tensor import DTensor

    loc = x.to_local()
    pieces = loc.reshape((n, loc.shape[0] // n) + tuple(loc.shape[1:]))
    return [DTensor.from_local(p, x.device_mesh, x.placements, run_check=False)
            for p in pieces]


def _value(x):
    return x.detach() if isinstance(x, torch.Tensor) else x


def make_train_step(cfg: ModelConfig, *, lr: float = 3e-4, weight_decay: float = 0.1,
                    dropless: bool = False, microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics),
    metrics ``ce``, ``aux``, ``loss`` and ``grad_norm``.  The parameters and
    the moments are updated in place (``adamw_update``).

    ``microbatches > 1`` splits the batch along its first axis and sums
    float32 gradients over the pieces, as the JAX package's scan does: the
    gradient and the loss are their means, the other metrics the last
    piece's."""

    def grads_of(params, batch):
        leaves = tree_leaves(params)
        loss, metrics = registry.loss_fn(to_port_layout(params), batch, cfg,
                                         dropless=dropless)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
        return loss.detach(), {k: _value(v) for k, v in metrics.items()}, grads

    def train_step(params, opt_state: AdamWState, batch: Dict[str, Any]):
        if microbatches == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            def split(x):
                b = x.shape[0]
                if b % microbatches:
                    raise ValueError(f"batch {b} does not split into {microbatches}")
                if is_dtensor(x):
                    return _split_shards(x, microbatches)
                return x.reshape((microbatches, b // microbatches) + tuple(x.shape[1:]))

            pieces = {k: split(v) for k, v in batch.items() if getattr(v, "ndim", 0)}
            scalars = {k: v for k, v in batch.items() if k not in pieces}
            acc, loss = None, 0.0
            for i in range(microbatches):
                li, metrics, g = grads_of(
                    params, dict({k: v[i] for k, v in pieces.items()}, **scalars))
                g = [x.float() for x in g]
                acc = g if acc is None else [a + b for a, b in zip(acc, g)]
                loss = loss + li
            grads = [a / microbatches for a in acc]
            loss = loss / microbatches
        params, opt_state, gnorm = adamw_update(
            tree_unflatten(params, grads), opt_state, params, lr=lr,
            weight_decay=weight_decay)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step

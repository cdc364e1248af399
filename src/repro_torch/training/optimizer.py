"""AdamW with decoupled weight decay and global-norm clipping, over a tree
of parameter tensors, with the JAX package's defaults and arithmetic: float32
moments, the update computed in float32 and cast back to the parameter's
type, bias correction from the step.

Plain PyTorch: the JAX package's optimizer is plain jnp, so no kernel
stands behind it.  Unlike the JAX function, which returns new trees, the
update writes the parameters and the moments in place (the trees it
returns are the ones it was given), which keeps one copy of the moments on
the card: at qwen3-1.7b's 1.72 B parameters they are 13.77 GB.

The arithmetic runs over consecutive slices of `SLICE` elements of each
leaf, so its float32 temporaries stay at a few slices whatever the leaf's
size.  The leaves are stacked over layers and can be large (gemma3-27b's
unembedding is 1.41 B elements, 5.25 GiB in float32), and the whole-leaf
expressions kept up to five float32 copies of a leaf alive at once.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.param import tree_leaves, tree_map

#: Elements of a slice: a float32 temporary of the update is 64 MiB at most.
SLICE = 1 << 24


class AdamWState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def adamw_init(params) -> AdamWState:
    """Zero float32 moments shaped as the parameters, step 0."""
    def zero(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=0, mu=tree_map(zero, params), nu=tree_map(zero, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32.  Each slice of
    `SLICE` elements is cast and squared alone and its float32 sum added to
    the total, so a leaf larger than a slice may give a norm a few float32
    steps from one sum over the whole leaf."""
    total = 0
    for g in tree_leaves(tree):
        for part in g.reshape(-1).split(SLICE):
            total = total + torch.sum(torch.square(part.float()))
    return torch.sqrt(total)


def _slices(*leaves):
    """The leaves' flat views cut into `SLICE`-element pieces, zipped; the
    whole leaves where one that is written (all but the first) is not
    contiguous."""
    if not all(x.is_contiguous() for x in leaves[1:]):
        return [leaves]
    return zip(leaves[0].reshape(-1).split(SLICE),
               *(x.view(-1).split(SLICE) for x in leaves[1:]))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr: float = 3e-4,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """One step: the gradients clipped to ``clip_norm`` by their global norm,
    the moments and the parameters updated in place, slice by slice (every
    element sees the operations of the whole-leaf expressions, in their
    order, so the bits do not depend on `SLICE`).  ``grads`` has the
    parameters' structure (any floating type).  -> (params, state with the
    step advanced, the global norm before clipping)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step_f = torch.tensor(float(step), dtype=torch.float32, device=gnorm.device)
    bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32, device=gnorm.device) ** step_f
    bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32, device=gnorm.device) ** step_f
    for leaves in zip(tree_leaves(grads), tree_leaves(state.mu),
                      tree_leaves(state.nu), tree_leaves(params)):
        for g, m, v, p in _slices(*leaves):
            g = g.float() * scale
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            pf = p.float()
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * pf
            p.copy_((pf - lr * delta).to(p.dtype))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), gnorm

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

DTensor parameters (the sharded path) are updated on their local shards:
the update is elementwise, and the global norm sums each shard's slices
and then reduces over the mesh.  On one device the bits are a plain tree's.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.param import is_dtensor, tree_leaves, tree_map

#: Elements of a slice: a float32 temporary of the update is 64 MiB at most.
SLICE = 1 << 24


class AdamWState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def adamw_init(params) -> AdamWState:
    """Zero float32 moments shaped as the parameters (laid out as a DTensor
    parameter is), step 0."""
    def zero(p):
        if is_dtensor(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(step=0, mu=tree_map(zero, params), nu=tree_map(zero, params))


def adamw_abstract(param_specs) -> AdamWState:
    """ParamSpec tree -> the (step, mu, nu) ParamSpecs: the dry-run's
    stand-ins, the moments float32 with the parameters' logical axes."""
    from repro_torch.models.param import ParamSpec

    f32 = tree_map(lambda s: ParamSpec(s.shape, s.logical, "float32", "zeros"), param_specs)
    return AdamWState(step=ParamSpec((), (), "int32", "zeros"), mu=f32,
                      nu=tree_map(lambda s: s, f32))


def _local(x):
    """A DTensor's local shard (the tensor itself otherwise)."""
    return x.to_local() if is_dtensor(x) else x


def _like_param(g, p):
    """A DTensor gradient laid out as its parameter (a partial sum reduced)."""
    if is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _sharded_mesh_dims(x) -> tuple:
    """The mesh dims a DTensor is sharded over (its replicas elsewhere hold
    the same elements); () for a plain tensor."""
    if not is_dtensor(x):
        return ()
    return tuple(i for i, p in enumerate(x.placements)
                 if p.is_shard() and x.device_mesh.size(i) > 1)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32.  Each slice of
    `SLICE` elements is cast and squared alone and its float32 sum added to
    the total, so a leaf larger than a slice may give a norm a few float32
    steps from one sum over the whole leaf.

    A DTensor leaf's slices are those of its local shard, and each slice's
    sum is summed over the mesh dims the leaf is sharded on (one all-reduce
    for all the slices of leaves sharded alike) before it joins the total in
    the same order; on one device the bits are those of a plain tree."""
    sums, dims = [], []
    for g in tree_leaves(tree):
        if is_dtensor(g) and any(p.is_partial() for p in g.placements):
            from torch.distributed.tensor import Replicate

            g = g.redistribute(g.device_mesh, [Replicate() if p.is_partial() else p
                                               for p in g.placements])
        for part in _local(g).reshape(-1).split(SLICE):
            sums.append(torch.sum(torch.square(part.float())))
            dims.append(_sharded_mesh_dims(g))
    groups = {}
    for i, d in enumerate(dims):
        if d:
            groups.setdefault(d, []).append(i)
    if groups:
        from torch.distributed._functional_collectives import all_reduce

        mesh = next(g.device_mesh for g in tree_leaves(tree) if is_dtensor(g))
        for d, idx in groups.items():
            red = torch.stack([sums[i] for i in idx])
            for m in d:
                red = all_reduce(red, "sum", (mesh, m))
            for j, i in enumerate(idx):
                sums[i] = red[j]
    total = 0
    for x in sums:
        total = total + x
    return torch.sqrt(total)


def _slices(*leaves):
    """The leaves' flat views cut into `SLICE`-element pieces, zipped; the
    whole leaves where one that is written (all but the first) is not
    contiguous.  DTensor leaves give their local shards' pieces (the
    update is elementwise)."""
    leaves = [_local(x) for x in leaves]
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
    grads = tree_map(_like_param, grads, params)
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

"""Parameter specs without JAX.

Every model declares an abstract parameter tree of :class:`ParamSpec`
leaves with the same names, shapes and init rules as the JAX package's
``abstract_params``; :func:`init_tree` materializes one with an explicit
``torch.Generator`` on an explicit device.  The tree keeps the JAX layout
(layer-stacked ``[nl, ...]`` leaves, HWIO convs); ``repro_torch.convert``
turns it into the layout the modules run on.

The ambient partitioner (``use_partitioner``) is how the models run sharded
without threading a mesh through every call: ``constrain`` redistributes a
DTensor to the layout its logical axes give, and the kernels' call sites
and ``moe_ffn`` ask ``current_partitioner`` whether to run under
``local_map``.  Without one, or on a plain tensor, nothing changes.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    dtype: Any = "bfloat16"
    init: str = "normal"   # normal | zeros | ones | small (0.006 normal)
    scale: float = 1.0


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def spec_leaves(tree):
    """(path, spec) pairs in sorted-key order, the order ``jax.tree``
    flattens a dict in."""
    if is_spec(tree):
        return [((), tree)]
    out = []
    for k in sorted(tree):
        out += [((k,) + p, s) for p, s in spec_leaves(tree[k])]
    return out


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, tuples and lists, in ``jax.tree``
    flatten order (dict keys sorted, sequences in order); a ParamSpec is a
    leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)) and not is_spec(tree):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of trees of the same
    structure in ``rest``), keeping the structure; leaves are visited in
    ``tree_leaves`` order (dict keys sorted), which ``tree_unflatten``
    relies on."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)) and not is_spec(tree):
        mapped = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*mapped) if hasattr(tree, "_fields") else type(tree)(mapped)
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure whose leaves are ``leaves``, taken in
    flatten order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def count(tree) -> int:
    return sum(math.prod(s.shape) for _, s in spec_leaves(tree))


#: Elements drawn by one ``torch.randn`` call: a leaf is drawn in pieces
#: of its flat layout, so the float32 draw never holds more than 1 GiB
#: beside the weights (gemma3-27b's [62, 5376, 21504] MLP leaves would take
#: 28.7 GB each whole, beside 57 GB of weights).
DRAW_ELEMS = 1 << 28


def materialize(spec: ParamSpec, generator: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """Normal with std ``scale / sqrt(fan_in)`` (fan_in = shape[0] for
    matrices), 0.006 * scale for ``small``, or zeros/ones."""
    dtype = getattr(torch, spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[0] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
    if spec.init == "small":
        std = 0.006 * spec.scale
    else:
        std = spec.scale / math.sqrt(max(fan_in, 1))
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    for piece in out.view(-1).split(DRAW_ELEMS):
        piece.copy_(torch.randn(piece.shape, generator=generator,
                                dtype=torch.float32, device=device) * std)
    return out


def zeros(spec_tree, device, like=None):
    """A tree of zero tensors for a ParamSpec tree (a decode cache); where
    ``like`` (a weight or activation of the model that asks) is a DTensor
    under a partitioner, DTensors laid out by each leaf's logical axes."""
    part = current_partitioner()
    if part is not None and is_dtensor(like):
        return tree_map(part.zeros, spec_tree)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=getattr(torch, s.dtype),
                                          device=device), spec_tree)


def init_tree(spec_tree, generator: torch.Generator, device) -> dict:
    """Materialize every leaf of a ParamSpec tree, drawn in sorted-key
    order from ``generator``."""
    out: dict = {}
    for path, spec in spec_leaves(spec_tree):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = materialize(spec, generator, device)
    return out


# --- ambient partitioner: models call constrain() without threading a mesh ---
#: The partitioner in use, process-wide: the autograd engine runs a CUDA
#: backward (and the recompute of a checkpointed layer) on threads of its
#: own, which a context variable would not reach.  Every thread sees it, so
#: it only acts on DTensors: a thread that runs on plain tensors meanwhile
#: runs unsharded.
_CURRENT = None


@contextlib.contextmanager
def use_partitioner(p):
    """Make ``p`` (or, for None, no partitioner) the ambient one until the
    block ends.  With one, a plain tensor that meets a DTensor in an op (a
    position index, an iota, a mask made on the spot) is taken as
    replicated (DTensor's ``implicit_replication``)."""
    global _CURRENT
    prev, _CURRENT = _CURRENT, p
    try:
        if p is None:
            yield p
        else:
            from torch.distributed.tensor.experimental import implicit_replication

            with implicit_replication():
                yield p
    finally:
        _CURRENT = prev


def current_partitioner():
    """The ambient partitioner, or None.  Only DTensors act on it."""
    return _CURRENT


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor to the layout of its logical axes; a no-op
    without a partitioner or on a plain tensor."""
    p = current_partitioner()
    if p is None or not is_dtensor(x):
        return x
    want = p.placements(x.shape, logical)
    return x if tuple(x.placements) == want else x.redistribute(p.mesh, want)

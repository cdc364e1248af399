"""Logical-axis sharding rules (MaxText-style) with divisibility guards, onto
DTensor.

Models annotate every parameter / activation dimension with a *logical* axis
name; a rule table maps logical names to mesh axes.  A dimension is sharded
on a mesh axis only when (a) the axis exists in the mesh, (b) the dim size is
divisible by the axis size, and (c) the axis is not already used by another
dimension of the same array.  Everything else is replicated: this is what
makes one rule table work across all 10 architectures (kv_heads=2 simply
replicates over the 16-way model axis instead of failing).

``partition_spec`` gives, per array dim, the mesh axes of the JAX package's
``PartitionSpec`` (a tuple, trailing ``None``s stripped); ``Partitioner``
turns it into DTensor placements, one per mesh dim (``placements``), and
distributes a tree of tensors by them (``distribute_tree``).  A mesh is a
``torch.distributed.DeviceMesh`` with named dims, or anything with
``axis_names`` and a ``devices`` array of the mesh's shape.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.models.param import tree_map

AxisRule = Union[None, str, Tuple[str, ...]]
#: a dim's mesh axes: None (replicated), one axis name, or several in order
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# Canonical rules shared by train + serve paths.
DEFAULT_RULES: Dict[str, AxisRule] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "seq_res": None,          # residual-stream seq dim; "model" = Megatron-SP
    "act_embed": None,        # activation d_model stays replicated over model
    "act_heads": "model",
    "act_mlp": "model",
    "act_vocab": "model",
    "expert_cap": "data",     # MoE dispatch-buffer capacity dim
    "cache_seq": None,        # long_500k overrides this to "data" (context par.)
    "cache_kv_heads": "model",
    # params: 2D sharding — FSDP over `data`, tensor over `model`
    "embed": "data",          # param d_model dim
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",           # param d_ff dim
    "experts": "model",       # expert-parallel when divisible
    "expert_mlp": None,       # per-expert ff dim (fallback shard target)
    "layers": None,           # stacked-layer leading dim
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
    "conv": None,
    "frames": None,
    "stats": None,            # scalar-ish optimizer stats
}


def _axes_of(rule: AxisRule) -> Tuple[str, ...]:
    if rule is None:
        return ()
    if isinstance(rule, str):
        return (rule,)
    return tuple(rule)


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, of a DeviceMesh or of a mesh-like object with
    ``axis_names`` and a ``devices`` array."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    shape = tuple(mesh.shape) if hasattr(mesh, "mesh_dim_names") else mesh.devices.shape
    return dict(zip(names, shape))


def partition_spec(
    shape: Sequence[int],
    logical: Sequence[Optional[str]],
    mesh,
    rules: Optional[Mapping[str, AxisRule]] = None,
) -> Spec:
    """Map logical dim names -> the mesh axes of each dim, with divisibility
    guards."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    if len(shape) != len(logical):
        raise ValueError(f"shape {shape} vs logical {logical} rank mismatch")
    sizes = mesh_sizes(mesh)
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        rule = rules.get(name) if name else None
        chosen = []
        for ax in _axes_of(rule):
            if ax not in sizes or ax in used:
                continue
            size = math.prod([sizes[a] for a in chosen]) * sizes[ax]
            if dim % size != 0:
                continue
            chosen.append(ax)
        for ax in chosen:
            used.add(ax)
        if not chosen:
            out.append(None)
        elif len(chosen) == 1:
            out.append(chosen[0])
        else:
            out.append(tuple(chosen))
    # strip trailing Nones (cosmetic)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def spec_placements(spec: Spec, mesh, shape: Sequence[int] = ()) -> tuple:
    """DTensor placements of a spec, one per mesh dim: ``Shard(d)`` on each
    mesh axis that dim d names (a dim over ("pod", "data") gives a Shard on
    both, and DTensor splits it in mesh order), ``Replicate()`` elsewhere.
    A dim of size 1 (which only an axis of size 1 divides) stays
    replicated: the layout is the same, and DTensor's views keep it."""
    from torch.distributed.tensor import Replicate, Shard

    place = {}
    for d, axes in enumerate(spec):
        if d < len(shape) and shape[d] == 1:
            continue
        for ax in _axes_of(axes):
            place[ax] = Shard(d)
    return tuple(place.get(ax, Replicate()) for ax in mesh.mesh_dim_names)


class Partitioner:
    """Holds a DeviceMesh + rule overrides; maps ParamSpec trees to specs
    and placements, and tensors to DTensors."""

    def __init__(self, mesh, rules: Optional[Mapping[str, AxisRule]] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES, **(rules or {}))

    def spec(self, shape: Sequence[int], logical: Sequence[Optional[str]]) -> Spec:
        return partition_spec(shape, logical, self.mesh, self.rules)

    def placements(self, shape: Sequence[int], logical: Sequence[Optional[str]]) -> tuple:
        return spec_placements(self.spec(shape, logical), self.mesh, shape)

    def distribute(self, x: torch.Tensor, logical: Sequence[Optional[str]]):
        """A whole tensor, the same on every rank, -> a DTensor laid out by
        its logical axes (each rank keeps its shard; nothing is sent)."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(x, self.mesh, self.placements(x.shape, logical),
                                 src_data_rank=None)

    def distribute_tree(self, params, specs):
        """A tree of whole tensors (``convert.params_from_numpy`` or
        ``init_tree``'s, in the JAX layout) and the ParamSpec tree it was
        made from -> the same tree of DTensors."""
        return tree_map(lambda s, x: self.distribute(x, s.logical), specs, params)

    def zeros(self, spec):
        """A DTensor of zeros for one ParamSpec, each rank allocating only its
        shard."""
        from torch.distributed.tensor import zeros

        return zeros(spec.shape, dtype=getattr(torch, spec.dtype), device_mesh=self.mesh,
                     placements=self.placements(spec.shape, spec.logical))

    def empty(self, spec):
        """The same, uninitialised (the dry-run's stand-ins)."""
        from torch.distributed.tensor import empty

        return empty(spec.shape, dtype=getattr(torch, spec.dtype), device_mesh=self.mesh,
                     placements=self.placements(spec.shape, spec.logical))

"""Per-chip analysis of one traced step of the port: flops, memory traffic,
collectives and the peak of live memory, counted on each rank's local shards.

The counterpart of the JAX package's ``launch/hlo_analysis.py`` (same file
name, so the two trees compare by name), which parses the compiled SPMD HLO
of a step.  The port has no HLO: its step is eager PyTorch over DTensors.
``analyze(fn, *args)`` runs the step once under a dispatch mode that sees
every aten op (and every custom op of the kernels) that DTensor runs on a
rank's *local* tensors, as they stand when the local op runs; the DTensor
ops themselves, whose shapes are global, are passed through uncounted, as
is DTensor's own shape propagation.  On the dry-run's fake tensors over a
fake process group nothing is allocated and no kernel is launched.

  * flops: ``torch.utils.flop_counter``'s registered formulas (matrix
    products, convolutions, attention) and the custom ops' own
    (``register_flop_formula`` in each kernel's ``ops.py``);
  * bytes: each op's inputs plus outputs, since an eager op is one kernel,
    as a fusion is in the reference; views, allocations without a write
    and the wait on a collective move nothing;
  * collectives: the functional collectives DTensor issues (all-gather,
    all-reduce, reduce-scatter, all-to-all), their operand bytes and
    counts by kind;
  * peak: the largest sum of live local storages, the step's arguments
    included.

Eager code has no while loops: a Python loop over layers or chunks runs
its body once per pass and is counted once per pass, so no trip count is
recovered.  All numbers are per chip.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

#: collective kinds by the functional collective's name (the JAX package's
#: kinds where one matches)
_COLLECTIVES = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
                ("reduce_scatter", "reduce-scatter"), ("all_to_all", "all-to-all"),
                ("broadcast", "broadcast"))
#: ops that move no data: allocation without a write, metadata, waits
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "device", "wait_tensor", "lift_fresh", "_local_scalar_dense", "sym_size",
               "sym_stride", "sym_numel", "sym_storage_offset", "set_"}

_skip = threading.local()


def _uncounted(fn, real_tensors: bool = False):
    """``fn`` run outside the count; with ``real_tensors`` also outside the
    fake mode (DTensor's layout arithmetic for strided shards builds an
    index tensor and reads it back, which a fake tensor cannot give)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    def wrapped(*a, **k):
        prev = getattr(_skip, "on", False)
        _skip.on = True
        try:
            with unset_fake_temporarily() if real_tensors else contextlib.nullcontext():
                return fn(*a, **k)
        finally:
            _skip.on = prev
    return wrapped


@contextlib.contextmanager
def _dtensor_internals_uncounted():
    """Context: DTensor's shape propagation (its ops on global fake tensors)
    and its strided-shard layout arithmetic run outside the count."""
    from torch.distributed.tensor import placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    patches = [(ShardingPropagator, "_propagate_tensor_meta_non_cached", False)]
    strided = getattr(placement_types, "_StridedShard", None)
    for name in ("local_shard_size_and_offset", "_local_shard_size_and_offset"):
        if strided is not None and name in vars(strided):
            patches.append((strided, name, True))
    saved = [(cls, name, vars(cls)[name]) for cls, name, _ in patches]
    for cls, name, real_tensors in patches:
        attr = vars(cls)[name]
        if isinstance(attr, staticmethod):
            setattr(cls, name, staticmethod(_uncounted(attr.__func__, real_tensors)))
        else:
            setattr(cls, name, _uncounted(attr, real_tensors))
    try:
        yield
    finally:
        for cls, name, attr in saved:
            setattr(cls, name, attr)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    from torch.distributed.tensor import DTensor

    out = []
    for x in tree_leaves(tree):
        if isinstance(x, DTensor):
            out.append(x._local_tensor)
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


class LocalCounter(TorchDispatchMode):
    """Counts the local ops of a step (see the module's docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.coll_bytes: Dict[str, float] = {}
        self.coll_count: Dict[str, float] = {}
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()
        self._refs = {}

    # -------------------------------------------------------- live memory
    def track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        if st in self._seen:
            return
        n = st.nbytes()
        key = id(st)
        self._seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)

        def freed(_ref, n=n, key=key):
            self.live -= n
            self._refs.pop(key, None)

        self._refs[key] = weakref.ref(st, freed)

    # ----------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if getattr(_skip, "on", False):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        if name in _NO_TRAFFIC or func.is_view:
            return out
        self.ops += 1
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        pkt = func._overloadpacket
        if pkt in flop_registry:
            self.flops += flop_registry[pkt](*args, **kwargs, out_val=out)
        moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.bytes += moved
        kind = next((k for n, k in _COLLECTIVES if n in name), None)
        if kind and "_c10d_functional" in func.namespace:
            b = sum(map(_nbytes, ins))
            self.coll_bytes[kind] = self.coll_bytes.get(kind, 0.0) + b
            self.coll_count[kind] = self.coll_count.get(kind, 0.0) + 1
        for t in outs:
            self.track(t)
        return out

    def stats(self) -> Dict[str, Any]:
        return {
            "flops": float(self.flops),
            "bytes_hbm": float(self.bytes),
            "collective_bytes_by_kind": dict(self.coll_bytes),
            "collective_count_by_kind": dict(self.coll_count),
            "collective_bytes": float(sum(self.coll_bytes.values())),
            "peak_bytes": int(self.peak),
            "n_ops": self.ops,
        }


def analyze(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once, counting its local ops; -> flops,
    bytes_hbm, collective bytes and counts by kind, collective_bytes,
    peak_bytes and n_ops, all per chip.  Arguments that are fake tensors
    (or DTensors over fake ones) run under their fake mode."""
    from torch._guards import detect_fake_mode

    fake = detect_fake_mode(_tensors((args, kwargs)))
    counter = LocalCounter()
    for t in _tensors((args, kwargs)):
        counter.track(t)
    with fake or contextlib.nullcontext(), _dtensor_internals_uncounted(), counter:
        out = fn(*args, **kwargs)
    stats = counter.stats()
    del out
    return stats

"""Dynamic cross-request microbatching for the workflow data plane.

The paper's throughput claim rests on keeping every stage's accelerator
saturated; one jitted dispatch per request leaves most of that on the
table.  This module is the mechanism the cluster layer uses to convert
O(requests) stage invocations into O(buckets):

  * ``bucket_key``    — structural shape/dtype signature of a payload.
                        Requests whose arrays agree on dtype and trailing
                        dims (everything but the leading batch axis) land
                        in the same bucket, so stacking them never changes
                        a jitted stage's input signature mid-bucket and
                        never triggers a recompile from shape mixing.
  * ``stack_payloads``— one batched pytree out of N request pytrees:
                        array leaves concatenate along axis 0, numeric
                        scalars stack to a [N] vector, strings/None keep a
                        per-request list.  Returns the per-request leading
                        -dim sizes needed to route results back.
  * ``unstack_payload``— the inverse, applied to a *result* pytree: every
                        array leaf splits along axis 0 by the recorded
                        sizes so each request's slice travels onward under
                        its own UID.
  * ``Coalescer``     — deadline-based batch formation: a bucket flushes
                        when it reaches ``max_batch`` or when its oldest
                        member has waited ``max_wait_s`` (bounded latency
                        cost; a lone request is never held hostage).

Everything here is numpy-level and knows nothing about rings, messages or
JAX — the cluster layer batches ``WorkflowMessage.payload``s with it and
the stage functions see one stacked pytree per invocation.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

Payload = Any


# ----------------------------------------------------------------- bucketing
def bucket_key(payload: Payload) -> Hashable:
    """Hashable structural signature: pytree shape, array dtypes and
    trailing dims.  Two payloads with equal keys can be stacked into one
    batch whose jitted trace is shared by every batch of the bucket (the
    leading dim still varies with batch size; pad with ``pad_to`` in
    ``stack_payloads`` to pin it)."""
    if isinstance(payload, np.ndarray) and payload.ndim >= 1:
        return ("nd", payload.dtype.str, payload.shape[1:])
    if isinstance(payload, (bool, int, float, np.generic)) or (
        isinstance(payload, np.ndarray) and payload.ndim == 0
    ):
        return ("num", np.asarray(payload).dtype.str)
    if isinstance(payload, str):
        return ("str",)
    if payload is None:
        return ("none",)
    if isinstance(payload, dict):
        return ("dict", tuple(sorted((k, bucket_key(v)) for k, v in payload.items())))
    if isinstance(payload, (list, tuple)):
        return ("seq", tuple(bucket_key(v) for v in payload))
    if isinstance(payload, (bytes, bytearray, memoryview)):
        return ("bytes",)
    raise TypeError(f"unbatchable payload leaf {type(payload)}")


def request_size(payload: Payload) -> int:
    """Leading-dim row count a request contributes to a stacked batch.
    Array leaves must agree; a payload with no array leaves counts as 1."""
    dims = set()

    def walk(x):
        if isinstance(x, np.ndarray) and x.ndim >= 1:
            dims.add(x.shape[0])
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(payload)
    if not dims:
        return 1
    if len(dims) > 1:
        raise ValueError(f"inconsistent leading dims in payload: {sorted(dims)}")
    return dims.pop()


class PerRequest(list):
    """Marker for leaves carried through a batch one-value-per-request
    (strings, None, bytes — things with no batch axis).  Distinguishes
    "hand request *i* element *i*" from a plain list, which is a pytree
    *container* whose elements are stacked/unstacked element-wise."""


# ------------------------------------------------------------- stack/unstack
def stack_payloads(
    payloads: Sequence[Payload], *, pad_to: Optional[int] = None
) -> Tuple[Payload, List[int]]:
    """Stack N same-bucket request payloads into one batched payload.

    Array leaves concatenate along axis 0; numeric scalar leaves become a
    [N] vector (one entry per request); str/None leaves become a
    ``PerRequest`` list.  ``pad_to`` repeats the last request until the
    batch holds that many requests (shape-stable batches for jit; the pad
    rows fall off at ``unstack_payload`` because ``sizes`` only covers the
    real requests).

    Returns ``(batched, sizes)`` where ``sizes[i]`` is request *i*'s
    leading-dim row count — exactly what ``unstack_payload`` needs to
    split the stage's result back out.
    """
    if not payloads:
        raise ValueError("stack_payloads needs at least one payload")
    key0 = bucket_key(payloads[0])
    for p in payloads[1:]:
        if bucket_key(p) != key0:
            raise ValueError("payloads from different buckets cannot be stacked")
    sizes = [request_size(p) for p in payloads]
    padded = list(payloads)
    if pad_to is not None and len(padded) < pad_to:
        padded += [padded[-1]] * (pad_to - len(padded))

    def merge(parts: List[Any]) -> Any:
        head = parts[0]
        if isinstance(head, np.ndarray) and head.ndim >= 1:
            return np.concatenate(parts, axis=0)
        if isinstance(head, (bool, int, float, np.generic)) or (
            isinstance(head, np.ndarray) and head.ndim == 0
        ):
            return np.asarray(parts)
        if isinstance(head, dict):
            return {k: merge([p[k] for p in parts]) for k in head}
        if isinstance(head, (list, tuple)):
            return type(head)(merge([p[i] for p in parts]) for i in range(len(head)))
        return PerRequest(parts)  # str / None / bytes: carried per request

    return merge(padded), sizes


def unstack_payload(batched: Payload, sizes: Sequence[int]) -> List[Payload]:
    """Split a stage result back into per-request slices.

    Array leaves with ``sum(sizes)`` leading rows split along axis 0 by
    ``sizes`` (each slice keeps its leading dim, so a request that entered
    as [1, ...] leaves as [1, ...]); array leaves with ``len(sizes)``
    leading entries (scalar leaves stacked one-per-request) hand request
    *i* entry *i*; ``PerRequest`` lists hand out one element per request;
    plain list/tuple containers recurse element-wise.  Rows beyond
    ``sum(sizes)`` (from ``pad_to``) are dropped.
    """
    n = len(sizes)
    offsets = np.cumsum([0] + list(sizes))
    total = int(offsets[-1])

    def split(x, i):
        if isinstance(x, np.ndarray) and x.ndim >= 1:
            # by-rows wins the n == total tie so [1,...] requests round-trip
            if x.shape[0] >= total:
                return x[offsets[i]: offsets[i + 1]]
            if x.shape[0] >= n:
                return x[i]  # one entry per request (stacked scalars)
            raise ValueError(
                f"result leading dim {x.shape[0]} covers neither "
                f"{total} rows nor {n} requests")
        if isinstance(x, dict):
            return {k: split(v, i) for k, v in x.items()}
        if isinstance(x, PerRequest):
            if len(x) < n:
                raise ValueError(
                    f"PerRequest leaf of {len(x)} entries for {n} requests")
            return x[i]
        if isinstance(x, (list, tuple)):
            return type(x)(split(v, i) for v in x)
        return x  # scalar / str / None: replicated to every request

    return [split(batched, i) for i in range(n)]


# --------------------------------------------------------------- coalescing
class Coalescer:
    """Deadline-based batch formation over an arbitrary item type.

    ``add`` buckets an item by key and returns a full batch the moment a
    bucket reaches ``max_batch``; ``pop_expired`` returns every bucket
    whose oldest item has waited ``max_wait_s`` (partial-batch flush —
    bounded added latency even at trickle arrival rates); ``pop_idle``
    flushes partial buckets early once the caller observes an arrival
    lull (adaptive flush — a trailing partial batch is not held for the
    full ``max_wait_s`` when no more same-bucket traffic is coming);
    ``flush_all`` drains everything (shutdown).  Single-consumer: the
    caller (one scheduler thread) owns the instance; no internal locking.
    """

    def __init__(self, max_batch: int = 8, max_wait_s: float = 0.002,
                 clock: Callable[[], float] = time.monotonic):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.clock = clock
        self._buckets: Dict[Hashable, List[Any]] = {}
        self._deadlines: Dict[Hashable, float] = {}
        # (bucket size, mark time) at the last pop_idle() sighting; a
        # bucket still that size after the grace window has seen no
        # traffic and is done growing
        self._idle_marks: Dict[Hashable, Tuple[int, float]] = {}

    def __len__(self) -> int:
        return sum(len(v) for v in self._buckets.values())

    def add(self, key: Hashable, item: Any) -> Optional[List[Any]]:
        """Bucket ``item``; returns the finished batch if this add filled
        the bucket to ``max_batch``, else None."""
        bucket = self._buckets.setdefault(key, [])
        if not bucket:
            self._deadlines[key] = self.clock() + self.max_wait_s
        bucket.append(item)
        self._idle_marks.pop(key, None)  # traffic: the bucket is not idle
        if len(bucket) >= self.max_batch:
            del self._buckets[key], self._deadlines[key]
            return bucket
        return None

    def pop_expired(self) -> List[Tuple[Hashable, List[Any]]]:
        """Flush every bucket whose deadline has passed."""
        now = self.clock()
        out = []
        for key in [k for k, d in self._deadlines.items() if d <= now]:
            out.append((key, self._buckets.pop(key)))
            del self._deadlines[key]
            self._idle_marks.pop(key, None)
        return out

    def pop_idle(
        self, grace_s: float = 0.0
    ) -> Tuple[List[Tuple[Hashable, List[Any]]], Optional[float]]:
        """Adaptive flush: called by the scheduler when its inbox came up
        empty.  A partial bucket that has not grown for ``grace_s`` is
        flushed immediately — the arrival lull means no more same-bucket
        traffic is in flight, so waiting out ``max_wait_s`` only adds
        latency.  A bucket that *did* grow since its mark gets a fresh
        grace window (``add`` also clears the mark).

        Returns ``(flushed, next_deadline)`` where ``next_deadline`` is
        the absolute clock time the earliest still-marked bucket becomes
        flushable (None if nothing is pending) — the caller's wake-up
        bound.
        """
        now = self.clock()
        out = []
        next_deadline: Optional[float] = None
        for key in list(self._buckets):
            size = len(self._buckets[key])
            mark = self._idle_marks.get(key)
            if mark is not None and mark[0] == size:
                if now - mark[1] >= grace_s:
                    out.append((key, self._buckets.pop(key)))
                    del self._deadlines[key]
                    del self._idle_marks[key]
                    continue
                due = mark[1] + grace_s
            else:
                self._idle_marks[key] = (size, now)
                due = now + grace_s
            next_deadline = due if next_deadline is None \
                else min(next_deadline, due)
        return out, next_deadline

    def next_deadline(self) -> Optional[float]:
        """Earliest pending deadline (absolute clock time), or None."""
        return min(self._deadlines.values()) if self._deadlines else None

    def flush_all(self) -> List[Tuple[Hashable, List[Any]]]:
        out = [(k, v) for k, v in self._buckets.items()]
        self._buckets.clear()
        self._deadlines.clear()
        self._idle_marks.clear()
        return out

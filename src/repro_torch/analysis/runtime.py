"""Runtime lock instrumentation.

Core modules create their locks through :func:`make_lock` /
:func:`make_rlock` instead of ``threading.Lock()`` directly.  By
default these return the plain ``threading`` primitives — zero
overhead in production.  When instrumentation is enabled (the pytest
plugin calls :func:`instrument_locks`, or ``REPRO_LOCK_CHECK=1``),
they return :class:`InstrumentedLock` wrappers that

* record every *nested* acquisition as an edge in the observed lock
  graph (instance-level: ``(name_a, id_a) -> (name_b, id_b)``), so the
  suite's real interleavings — not just the static over-approximation —
  feed cycle detection;
* track contention stats per lock name: acquisitions, contended
  acquisitions, total/max wait, total/max hold (surfaced through
  ``WorkflowSet.transport_stats()``).

Cycle detection runs on instance-level edges: ``A.lock -> B.lock`` and
``B.lock -> A.lock`` on *distinct instance pairs in consistent order*
(the canonical ``id()``-ordered ``absorb``) is NOT a cycle, while the
same pair acquired in both orders is.  Reentrant RLock re-acquisition
by the owning thread adds no edge.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

_enabled = os.environ.get("REPRO_LOCK_CHECK", "") not in ("", "0")

_tls = threading.local()


def _held_stack() -> List["InstrumentedLock"]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class LockStats:
    __slots__ = ("name", "acquisitions", "contended", "wait_s", "hold_s",
                 "max_wait_s", "max_hold_s")

    def __init__(self, name: str):
        self.name = name
        self.acquisitions = 0
        self.contended = 0
        self.wait_s = 0.0
        self.hold_s = 0.0
        self.max_wait_s = 0.0
        self.max_hold_s = 0.0

    def as_dict(self) -> dict:
        return {"acquisitions": self.acquisitions,
                "contended": self.contended,
                "wait_s": round(self.wait_s, 6),
                "hold_s": round(self.hold_s, 6),
                "max_wait_s": round(self.max_wait_s, 6),
                "max_hold_s": round(self.max_hold_s, 6)}


class LockGraph:
    """Observed acquisition graph.  Nodes are (name, instance_id); a
    name-level view aggregates stats; cycles are found instance-level."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self.edges: Dict[Tuple[Tuple[str, int], Tuple[str, int]],
                         Tuple[str, str]] = {}
        self.stats: Dict[str, LockStats] = {}

    def stat(self, name: str) -> LockStats:
        with self._mu:
            s = self.stats.get(name)
            if s is None:
                s = self.stats[name] = LockStats(name)
            return s

    def add_edge(self, outer: "InstrumentedLock",
                 inner: "InstrumentedLock") -> None:
        key = ((outer.name, id(outer)), (inner.name, id(inner)))
        with self._mu:
            if key not in self.edges:
                self.edges[key] = (outer.name, inner.name)

    def record(self, name: str, waited: float, held: float,
               contended: bool) -> None:
        with self._mu:
            s = self.stats.get(name)
            if s is None:
                s = self.stats[name] = LockStats(name)
            s.acquisitions += 1
            s.contended += 1 if contended else 0
            s.wait_s += waited
            s.hold_s += held
            s.max_wait_s = max(s.max_wait_s, waited)
            s.max_hold_s = max(s.max_hold_s, held)

    def find_cycles(self) -> List[List[str]]:
        with self._mu:
            adj: Dict[Tuple[str, int], Set[Tuple[str, int]]] = {}
            for (a, b) in self.edges:
                adj.setdefault(a, set()).add(b)
                adj.setdefault(b, set())
        cycles: List[List[str]] = []
        seen: Set[Tuple] = set()
        color: Dict[Tuple[str, int], int] = {}
        stack: List[Tuple[str, int]] = []

        def dfs(u) -> None:
            color[u] = 1
            stack.append(u)
            for v in adj.get(u, ()):
                if color.get(v, 0) == 0:
                    dfs(v)
                elif color.get(v) == 1:
                    i = stack.index(v)
                    cyc = stack[i:] + [v]
                    key = tuple(sorted(set(cyc)))
                    if key not in seen:
                        seen.add(key)
                        cycles.append(
                            [f"{n}@{iid & 0xffff:04x}" for n, iid in cyc])
            stack.pop()
            color[u] = 2

        for n in sorted(adj):
            if color.get(n, 0) == 0:
                dfs(n)
        return cycles

    def snapshot_stats(self) -> Dict[str, dict]:
        with self._mu:
            return {n: s.as_dict() for n, s in sorted(self.stats.items())}

    def clear(self) -> None:
        with self._mu:
            self.edges.clear()
            self.stats.clear()


_default_graph = LockGraph()


def default_graph() -> LockGraph:
    return _default_graph


class InstrumentedLock:
    """Drop-in for threading.Lock/RLock that records ordering + stats.

    The underlying primitive provides the actual mutual exclusion; all
    bookkeeping happens on the acquiring thread (the held-stack is
    thread-local; graph/stat maps take an internal mutex that is only
    ever a leaf)."""

    def __init__(self, name: str, *, reentrant: bool = False,
                 graph: Optional[LockGraph] = None):
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._graph = graph or _default_graph
        self._depth = 0              # written only by the owning thread
        self._acquired_at = 0.0
        self._waited = 0.0
        self._contended = False

    # ------------------------------------------------------------ lock API
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        reentry = (self.reentrant
                   and any(l is self for l in _held_stack()))
        t0 = time.perf_counter()
        got = self._inner.acquire(blocking, timeout)
        if not got:
            return False
        waited = time.perf_counter() - t0
        if reentry:
            self._depth += 1
            return True
        stack = _held_stack()
        for outer in stack:
            if outer is not self:
                self._graph.add_edge(outer, self)
        stack.append(self)
        self._depth = 1
        self._acquired_at = time.perf_counter()
        self._waited = waited
        self._contended = waited > 1e-4
        return True

    def release(self) -> None:
        if self._depth > 1:
            self._depth -= 1
            self._inner.release()
            return
        held = time.perf_counter() - self._acquired_at
        self._graph.record(self.name, self._waited, held, self._contended)
        stack = _held_stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break
        self._depth = 0
        self._inner.release()

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        if self.reentrant:
            return self._depth > 0
        return self._inner.locked()

    def __repr__(self) -> str:
        return f"InstrumentedLock({self.name!r})"


# --------------------------------------------------------------- factories
def instrument_locks(on: bool = True) -> None:
    """Globally switch make_lock()/make_rlock() to instrumented mode.
    Only affects locks created AFTER the call."""
    global _enabled
    _enabled = on


def instrumentation_enabled() -> bool:
    return _enabled


def make_lock(name: str):
    """A mutex for ``name`` (e.g. "JoinTable._lock").  Plain
    threading.Lock unless instrumentation is enabled."""
    if _enabled:
        return InstrumentedLock(name)
    return threading.Lock()


def make_rlock(name: str):
    if _enabled:
        return InstrumentedLock(name, reentrant=True)
    return threading.RLock()


def lock_stats_snapshot() -> Dict[str, dict]:
    """Per-lock-name contention stats gathered so far ({} when the
    suite runs uninstrumented)."""
    return _default_graph.snapshot_stats()

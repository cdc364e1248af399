"""Transient result store (§3.4, §7): memory-centric, TTL-purged,
consensus-free replication, fetch-one-try-next client protocol.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.analysis.runtime import make_lock


@dataclass
class _Entry:
    value: Any
    stored_at: float
    ttl_s: float


class DatabaseInstance:
    """One in-memory replica. Results are purged on fetch ("typically
    accessed only once") or when the TTL expires."""

    def __init__(self, name: str, *, default_ttl_s: float = 300.0,
                 purge_on_fetch: bool = True, clock=time.monotonic):
        self.name = name
        self.default_ttl_s = default_ttl_s
        self.purge_on_fetch = purge_on_fetch
        self.clock = clock
        self._lock = make_lock("DatabaseInstance._lock")
        self._data: Dict[str, _Entry] = {}  # guarded_by: _lock
        self.alive = True

    def store(self, uid: str, value: Any, ttl_s: Optional[float] = None) -> None:
        if not self.alive:
            raise ConnectionError(f"db {self.name} down")
        with self._lock:
            self._data[uid] = _Entry(value, self.clock(), ttl_s or self.default_ttl_s)

    def fetch(self, uid: str) -> Optional[Any]:
        if not self.alive:
            raise ConnectionError(f"db {self.name} down")
        with self._lock:
            e = self._data.get(uid)
            if e is None:
                return None
            if self.clock() - e.stored_at > e.ttl_s:
                del self._data[uid]
                return None
            if self.purge_on_fetch:
                del self._data[uid]
            return e.value

    def purge(self, uid: str) -> None:
        if not self.alive:
            raise ConnectionError(f"db {self.name} down")
        with self._lock:
            self._data.pop(uid, None)

    def scan(self, prefix: str) -> Dict[str, Any]:
        """Non-destructive prefix scan (skips expired entries) — used by
        JoinTable.recover to rebuild fan-in state from the replicas."""
        if not self.alive:
            raise ConnectionError(f"db {self.name} down")
        now = self.clock()
        with self._lock:
            return {k: e.value for k, e in self._data.items()
                    if k.startswith(prefix) and now - e.stored_at <= e.ttl_s}

    def purge_expired(self) -> int:
        now = self.clock()
        with self._lock:
            dead = [k for k, e in self._data.items() if now - e.stored_at > e.ttl_s]
            for k in dead:
                del self._data[k]
            return len(dead)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)


class ReplicatedDatabase:
    """Client/ResultDeliver-side view over the replicas of one Workflow Set.

    Writes go to every live replica (reliable RDMA transport makes this a
    plain fan-out — §7: no consensus needed for transient results).  Reads
    query ONE instance at a time and fall through to the next on miss or
    failure (§7).
    """

    def __init__(self, replicas: Sequence[DatabaseInstance]):
        self.replicas = list(replicas)
        self._lock = make_lock("ReplicatedDatabase._lock")
        # uids whose post-fetch purge could not reach a replica (it was
        # down at the time): applied on the next touch once it recovers,
        # so a purged "accessed-once" result can never resurrect there.
        self._missed_purges: List[set] = [set() for _ in self.replicas]  # guarded_by: _lock
        # broadcast doorbell: set on every successful store so result
        # pollers (Proxy.wait_result) sleep until data lands instead of
        # polling at a fixed interval.  Waiters clear-then-repoll; a
        # spurious wake just costs one extra fetch.
        self._store_event = threading.Event()

    def _flush_missed_purges(self, idx: int, r: DatabaseInstance) -> None:
        # Unlocked emptiness probe: the outer list never changes shape, and
        # a stale non-empty read just means one extra locked check.
        if not self._missed_purges[idx]:  # analysis: ignore[guarded-field] -- benign racy fast path
            return
        with self._lock:
            pending = list(self._missed_purges[idx])
        for uid in pending:
            try:
                r.purge(uid)
            except ConnectionError:
                return  # still down; keep the backlog
            with self._lock:
                self._missed_purges[idx].discard(uid)

    def store(self, uid: str, value: Any, ttl_s: Optional[float] = None) -> int:
        ok = 0
        for idx, r in enumerate(self.replicas):
            self._flush_missed_purges(idx, r)
            try:
                r.store(uid, value, ttl_s)
                ok += 1
            except ConnectionError:
                continue
            # same benign racy emptiness probe as _flush_missed_purges
            if self._missed_purges[idx]:  # analysis: ignore[guarded-field] -- benign racy fast path
                with self._lock:
                    # a fresh store supersedes any purge deferred for this uid
                    self._missed_purges[idx].discard(uid)
        if ok == 0:
            raise ConnectionError("all database replicas down")
        self._store_event.set()
        return ok

    def wait_store(self, timeout_s: float) -> bool:
        """Block until *some* store lands (or the timeout passes).  The
        event is shared by all waiters, so a waiter must re-check its own
        uid after waking; the bounded timeout covers the multi-waiter
        race where another waiter consumed the signal first."""
        if self._store_event.wait(timeout_s):
            self._store_event.clear()
            return True
        return False

    def purge(self, uid: str) -> None:
        """Explicit purge on every replica (fan-in joins claim their
        partials this way).  A replica that is down gets the purge deferred
        exactly like a post-fetch purge, so the entry cannot resurrect."""
        for idx, r in enumerate(self.replicas):
            try:
                r.purge(uid)
            except ConnectionError:
                with self._lock:
                    self._missed_purges[idx].add(uid)

    def scan(self, prefix: str) -> Dict[str, Any]:
        """Prefix union across live replicas (first replica seen wins)."""
        out: Dict[str, Any] = {}
        for idx, r in enumerate(self.replicas):
            self._flush_missed_purges(idx, r)
            try:
                found = r.scan(prefix)
            except ConnectionError:
                continue
            for k, v in found.items():
                out.setdefault(k, v)
        return out

    def fetch(self, uid: str) -> Optional[Any]:
        value = None
        missed: List[int] = []
        for idx, r in enumerate(self.replicas):
            self._flush_missed_purges(idx, r)
            if value is not None:
                # propagate the purge: "data is automatically purged" after
                # a successful client fetch (§3.4)
                if r.purge_on_fetch:
                    try:
                        r.purge(uid)
                    except ConnectionError:
                        missed.append(idx)
                continue
            try:
                v = r.fetch(uid)
            except ConnectionError:
                missed.append(idx)
                continue
            if v is not None:
                value = v
        if value is not None:
            # replicas that were unreachable anywhere around the hit never
            # saw the purge — defer it so the result cannot resurrect after
            # they recover
            with self._lock:
                for idx in missed:
                    if self.replicas[idx].purge_on_fetch:
                        self._missed_purges[idx].add(uid)
        return value

"""Fan-in join assembly for DAG workflows (docs/workflows.md).

A fan-in stage (two or more deps) cannot run until every upstream branch
has produced its partial for a given request.  Partials are assembled here,
keyed by **request UID + fan-in stage**, not on any workflow instance:

  * each upstream branch's ResultDeliver ``offer``s its partial instead of
    appending to a next-hop inbox;
  * the offer that completes the set claims the join and routes ONE merged
    message to the fan-in stage's live instances;
  * every partial is mirrored into the ReplicatedDatabase write stream
    under ``join/<app>/<stage_idx>/<uid>/<branch>`` so an assembled-in-
    progress join survives database-replica failure and can be rebuilt
    (``recover``) — and because no instance owns the join, evicting or
    drain-reassigning a fan-in instance (PR 4) never strands a partial.

Drop accounting rides the same table: any drop site that knows its
message's UID calls ``mark_dropped`` — the UID is tombstoned, sibling
partials already assembled are discarded (never delivered partially), and
future offers for it are refused.  Set-wide the §9 invariant becomes
per-request: every submitted UID is either stored (exactly one joined
result) or in ``dropped_uids``; ``pending_uids`` exposes the remainder for
reconciliation after a quiesce.

The table also carries the **wire ledger** for tracked shipments
(docs/disaggregation.md): a bulk single-dep transfer whose loss the
receiver can only see as a checksum-failed ring entry — a corrupt entry
decodes no UID — is ``track_wire``'d by the sender before the append and
``settle_wire``'d by the receiver at unpack.  A shipment that never
settles stays in ``pending_uids`` (reconciled as dead after a quiesce)
and is tombstoned by the TTL sweep, so even a silently dropped KV-cache
ship keeps ``submitted == stored ∪ dead_uids()``.

State is bounded like the transient database's: stranded partials (their
sibling was lost with no decodable UID) and tombstones both expire after
``ttl_s`` via a lazy sweep, so a long-running set cannot leak joins.

Merge semantics are deterministic: dict partials union in dependency
order (later deps overwrite on key conflicts); any non-dict partial
demotes the merge to ``{branch_name: partial}``.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Set, Tuple

from repro_torch.analysis.runtime import make_lock
from repro_torch.cluster.database import ReplicatedDatabase

#: ``offer`` outcome: the UID was tombstoned by a drop elsewhere — discard.
JOIN_DEAD = object()
#: ``offer`` outcome: recorded, waiting for the remaining branches.
JOIN_PENDING = object()

_DB_PREFIX = "join/"


def merge_partials(parts: Dict[str, Any], order: Sequence[str]) -> Any:
    """Deterministic fan-in merge (dependency order)."""
    if all(isinstance(parts[b], dict) for b in order):
        merged: Dict[str, Any] = {}
        for b in order:
            merged.update(parts[b])
        return merged
    return {b: parts[b] for b in order}


@dataclass
class JoinStats:
    offered: int = 0            # partials recorded
    completed: int = 0          # joins assembled and claimed
    dead_offers: int = 0        # partials refused (UID tombstoned)
    aborted_joins: int = 0      # in-progress joins discarded by a tombstone
    discarded_partials: int = 0
    expired_joins: int = 0      # stranded joins evicted by the TTL sweep
    expired_tombstones: int = 0
    expired_shipments: int = 0  # tracked wire transfers never settled
    db_write_failures: int = 0  # partial mirror writes that found no replica


class JoinTable:
    """One per Workflow Set, shared by every proxy and instance (like the
    ReplicatedDatabase it mirrors into)."""

    def __init__(self, database: Optional[ReplicatedDatabase] = None, *,
                 ttl_s: float = 300.0, clock=time.monotonic,
                 async_mirror: bool = False):
        self.database = database
        self.ttl_s = ttl_s
        self.clock = clock
        # Durability mirroring is off the request critical path when
        # ``async_mirror`` is set (WorkflowSet does): every mirror op —
        # stores AND purges — funnels through ONE FIFO queue drained by a
        # daemon thread, so store-then-purge ordering per key is exactly
        # the synchronous order.  ``flush_mirror`` is the barrier.  Sync
        # (the default) keeps mirror writes immediately visible, which
        # the durability unit tests and ``recover`` callers rely on.
        self._mirror_q: Optional["queue.Queue[Callable[[], None]]"] = None
        if async_mirror and database is not None:
            self._mirror_q = queue.Queue()
            threading.Thread(target=self._mirror_loop,
                             name="JoinTable.mirror", daemon=True).start()
        self._lock = make_lock("JoinTable._lock")
        # (app_id, stage_idx, uid_hex) -> {branch stage name: partial payload}
        self._pending: Dict[Tuple[int, int, str], Dict[str, Any]] = {}  # guarded_by: _lock
        self._pending_at: Dict[Tuple[int, int, str], float] = {}  # guarded_by: _lock
        #: UIDs known dead anywhere in the pipeline (per-request §9 ledger).
        #: Membership tests are safe anywhere; to iterate, take
        #: ``dropped_snapshot()`` — the raw set mutates under you.
        self.dropped_uids: Set[str] = set()  # guarded_by: _lock
        self._dropped_at: Dict[str, float] = {}  # guarded_by: _lock
        #: wire ledger — tracked bulk shipments awaiting receiver settle
        self._wire: Dict[str, float] = {}  # guarded_by: _lock
        self._last_sweep = clock()
        self.stats = JoinStats()  # guarded_by: _lock

    @staticmethod
    def _db_key(app_id: int, stage_idx: int, uid_hex: str, branch: str) -> str:
        return f"{_DB_PREFIX}{app_id}/{stage_idx}/{uid_hex}/{branch}"

    # ---------------------------------------------------------- mirror plumbing
    def _mirror_loop(self) -> None:
        while True:
            fn = self._mirror_q.get()
            try:
                fn()
            except Exception:
                pass  # durability is best-effort; never kill the drain
            finally:
                self._mirror_q.task_done()

    def _mirror(self, fn: Callable[[], None]) -> None:
        """Run one mirror op: inline (sync mode) or via the FIFO drain."""
        if self._mirror_q is not None:
            self._mirror_q.put(fn)
        else:
            fn()

    def flush_mirror(self) -> None:
        """Barrier: every mirror op enqueued so far has executed.  No-op
        in sync mode.  Call before ``recover`` or before tearing down the
        database replicas (``WorkflowSet.stop`` does)."""
        if self._mirror_q is not None:
            self._mirror_q.join()

    def _purge_mirror(self, key: Tuple[int, int, str], parts) -> None:
        if self.database is not None:
            branches = list(parts)

            def do_purge():
                for b in branches:
                    self.database.purge(
                        self._db_key(key[0], key[1], key[2], b))

            self._mirror(do_purge)

    def _sweep_locked(self) -> None:
        """Lazy TTL GC (caller holds the lock): evict stranded joins and
        aged-out tombstones so the table stays bounded like the transient
        database it mirrors.  Runs at most ~once a second."""
        now = self.clock()
        if now - self._last_sweep < min(1.0, self.ttl_s):
            return
        self._last_sweep = now
        for key in [k for k, t in self._pending_at.items()
                    if now - t > self.ttl_s]:
            parts = self._pending.pop(key, {})
            del self._pending_at[key]
            self.stats.expired_joins += 1
            self.stats.discarded_partials += len(parts)
            self._purge_mirror(key, parts)
        for uid in [u for u, t in self._dropped_at.items()
                    if now - t > self.ttl_s]:
            del self._dropped_at[uid]
            self.dropped_uids.discard(uid)
            self.stats.expired_tombstones += 1
        # Wire-ledger expiry tombstones (rather than forgets): a shipment
        # that never settled is a *known* drop — keep the §9 invariant
        # even after the pending window closes.
        for uid in [u for u, t in self._wire.items() if now - t > self.ttl_s]:
            del self._wire[uid]
            self.dropped_uids.add(uid)
            self._dropped_at[uid] = now
            self.stats.expired_shipments += 1

    # --------------------------------------------------------------- offers
    def offer(self, app_id: int, stage_idx: int, uid_hex: str, branch: str,
              payload: Any, expected: Sequence[str]) -> Any:
        """Record one branch's partial.  Returns ``JOIN_DEAD`` (UID was
        dropped elsewhere), ``JOIN_PENDING`` (branches still missing), or
        the merged payload — in which case the join is claimed (removed)
        and the caller must route the assembled message onward."""
        key = (app_id, stage_idx, uid_hex)
        with self._lock:
            self._sweep_locked()
            if uid_hex in self.dropped_uids:
                self.stats.dead_offers += 1
                return JOIN_DEAD
            parts = self._pending.setdefault(key, {})
            self._pending_at.setdefault(key, self.clock())
            parts[branch] = payload
            self.stats.offered += 1
            complete = set(parts) >= set(expected)
            if complete:
                del self._pending[key]
                del self._pending_at[key]
                self.stats.completed += 1
        # DB mirroring runs OUTSIDE the table lock (the payloads are whole
        # tensor partials — copying them into every replica under one
        # set-wide mutex would serialize all branches of all requests).
        # Atomicity of claim-vs-slow-sibling-store is restored by a
        # post-store check: if the join was claimed or tombstoned while we
        # were storing, our mirror entry is stale — purge it.  In
        # async_mirror mode the whole op runs on the mirror drain thread
        # instead — off the request critical path, same per-key order.
        if self.database is not None:
            if complete:
                exp = list(expected)

                def claim_purge():
                    for b in exp:
                        self.database.purge(self._db_key(app_id, stage_idx,
                                                         uid_hex, b))

                self._mirror(claim_purge)
            else:
                def mirror_store():
                    try:
                        self.database.store(
                            self._db_key(app_id, stage_idx, uid_hex, branch),
                            payload)
                    except ConnectionError:  # all replicas down: memory only
                        with self._lock:
                            self.stats.db_write_failures += 1
                    else:
                        with self._lock:
                            stale = (key not in self._pending
                                     or uid_hex in self.dropped_uids)
                        if stale:
                            self.database.purge(
                                self._db_key(app_id, stage_idx, uid_hex,
                                             branch))

                self._mirror(mirror_store)
        if not complete:
            return JOIN_PENDING
        return merge_partials(parts, expected)

    # ---------------------------------------------------- per-UID drop ledger
    def mark_dropped(self, uid_hex: str) -> bool:
        """Tombstone a request: called by every drop site that knows its
        UID (proxy entrance drops, stage-fn failures, delivery drops,
        terminal drains).  Sibling partials already assembled are discarded
        so a half-joined request can never be delivered.  Returns True the
        first time the UID is marked (drop accounting counts requests
        once)."""
        with self._lock:
            self._sweep_locked()
            first = uid_hex not in self.dropped_uids
            self.dropped_uids.add(uid_hex)
            self._dropped_at[uid_hex] = self.clock()
            self._wire.pop(uid_hex, None)  # a dead request owes no settle
            for key in [k for k in self._pending if k[2] == uid_hex]:
                parts = self._pending.pop(key)
                del self._pending_at[key]
                self.stats.aborted_joins += 1
                self.stats.discarded_partials += len(parts)
                self._purge_mirror(key, parts)
        return first

    # ------------------------------------------------------------ wire ledger
    def track_wire(self, uid_hex: str) -> None:
        """Sender side: record a bulk shipment (e.g. a KV-cache ship)
        whose silent wire loss the receiver could only observe as a
        corrupt ring entry with no decodable UID.  Until the receiver
        settles it, the UID counts as pending (→ dead after a quiesce)."""
        with self._lock:
            if uid_hex not in self.dropped_uids:
                self._wire.setdefault(uid_hex, self.clock())

    def settle_wire(self, uid_hex: str) -> None:
        """Receiver side: the tracked shipment arrived intact."""
        with self._lock:
            self._wire.pop(uid_hex, None)

    def wire_pending(self) -> int:
        with self._lock:
            return len(self._wire)

    # ------------------------------------------------------------- queries
    def dropped_snapshot(self) -> Set[str]:
        """Locked copy of the tombstone set — the only safe way to iterate
        it while drop sites may be firing concurrently."""
        with self._lock:
            return set(self.dropped_uids)

    def pending_uids(self) -> Set[str]:
        """UIDs with at least one partial still waiting, plus tracked wire
        shipments not yet settled — after a quiesce these are requests a
        lost sibling branch or a dropped shipment stranded (reconciled as
        drops by ``WorkflowSet.dead_uids``)."""
        with self._lock:
            return {k[2] for k in self._pending} | set(self._wire)

    def pending_joins(self) -> int:
        with self._lock:
            return len(self._pending)

    # ------------------------------------------------------------- recovery
    def recover(self, nm=None) -> Tuple[int, list]:
        """Rebuild the in-memory index from the database replicas' join
        namespace (a restarted assembler missed every offer while it was
        down; call while offers are quiesced).  Tombstoned UIDs stay dead.

        Returns ``(n_recovered, ready)``.  A join whose *complete* branch
        set was recovered will never see another offer — with ``nm``
        provided (anything answering ``workflows[app_id]``), such joins
        are claimed here and returned in ``ready`` as
        ``(app_id, stage_idx, uid_hex, merged_payload)`` for the caller to
        route to the fan-in stage; without ``nm`` they stay pending."""
        if self.database is None:
            return 0, []
        self.flush_mirror()  # async mode: make every queued mirror op visible
        recovered = 0
        for key, value in self.database.scan(_DB_PREFIX).items():
            try:
                app_s, stage_s, uid_hex, branch = \
                    key[len(_DB_PREFIX):].split("/", 3)
                jkey = (int(app_s), int(stage_s), uid_hex)
            except ValueError:
                continue
            with self._lock:
                if uid_hex in self.dropped_uids:
                    continue
                parts = self._pending.setdefault(jkey, {})
                self._pending_at.setdefault(jkey, self.clock())
                if branch not in parts:
                    parts[branch] = value
                    recovered += 1
        ready: list = []
        if nm is not None:
            with self._lock:
                for jkey in list(self._pending):
                    app_id, stage_idx, uid_hex = jkey
                    try:
                        wf = nm.workflows[app_id]
                        expected = wf.deps_of(wf.stages[stage_idx].name)
                    except (KeyError, IndexError):
                        continue
                    parts = self._pending[jkey]
                    if set(parts) >= set(expected):
                        del self._pending[jkey]
                        del self._pending_at[jkey]
                        self.stats.completed += 1
                        self._purge_mirror(jkey, expected)
                        ready.append((app_id, stage_idx, uid_hex,
                                      merge_partials(parts, expected)))
        return recovered, ready

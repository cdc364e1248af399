"""Workflow Set (§3.1): one regionally-autonomous set of proxies, workflow
instances and databases over a shared RDMA fabric, able to execute complete
workflows independently.  Multiple sets + random request spreading give the
cross-set balancing and fault isolation of §3.
"""
from __future__ import annotations

import random
import threading
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.cluster.database import DatabaseInstance, ReplicatedDatabase
from repro_torch.cluster.instance import WorkflowInstance
from repro_torch.cluster.join import JoinTable
from repro_torch.cluster.node_manager import (
    ControlLoop,
    NodeManager,
    StageSpec,
    WorkflowSpec,
)
from repro_torch.analysis.runtime import lock_stats_snapshot
from repro_torch.cluster.proxy import Proxy, Rejected
from repro_torch.core.profiling import profiler
from repro_torch.core.rdma import RdmaFabric
from repro_torch.core.request_monitor import RequestMonitor
from repro_torch.core.ring_buffer import DoubleRingBuffer
from repro_torch.core.transport import ChannelStats


class WorkflowSet:
    def __init__(self, name: str, *, n_databases: int = 2,
                 nm: Optional[NodeManager] = None,
                 control_loop: bool = True,
                 control_interval_s: float = 0.05,
                 liveness_timeout_s: float = 2.0):
        self.name = name
        self.fabric = RdmaFabric()
        self.nm = nm or NodeManager()
        self.buffers: Dict[str, DoubleRingBuffer] = {}
        self.instances: Dict[str, WorkflowInstance] = {}
        self.db_instances = [
            DatabaseInstance(f"{name}.db{i}") for i in range(n_databases)
        ]
        for dbi in self.db_instances:
            self.nm.register_instance(dbi.name, role="database")
        self.database = ReplicatedDatabase(self.db_instances)
        # Fan-in assembly + per-UID drop ledger, shared by every proxy and
        # instance; partials replicate through the database write stream.
        # async_mirror keeps the durability writes off the per-message
        # critical path (drained FIFO; ``stop`` flushes the backlog).
        self.joins = JoinTable(self.database, async_mirror=True)
        self.proxies: List[Proxy] = []
        self._control_loop = control_loop
        self._control_interval_s = control_interval_s
        self._liveness_timeout_s = liveness_timeout_s
        self.control: Optional[ControlLoop] = None
        self._started = False

    # ------------------------------------------------------------ assembly
    def add_instance(self, name: str, *, n_workers: int = 1, mode: str = "IM",
                     stage: Optional[str] = None, **kw) -> WorkflowInstance:
        inst = WorkflowInstance(
            f"{self.name}.{name}", self.fabric, self.nm,
            n_workers=n_workers, mode=mode, database=self.database,
            buffers=self.buffers, joins=self.joins, **kw,
        )
        self.instances[inst.name] = inst
        if stage is not None:
            self.nm.assign(inst.name, stage)
        return inst

    def add_proxy(self, name: str, *, monitor: Optional[RequestMonitor] = None) -> Proxy:
        p = Proxy(f"{self.name}.{name}", self.fabric, self.nm, self.database,
                  self.buffers, monitor=monitor, joins=self.joins)
        self.proxies.append(p)
        return p

    def register_workflow(self, wf: WorkflowSpec) -> None:
        self.nm.register_workflow(wf)

    # ------------------------------------------------------------- telemetry
    def transport_stats(self) -> ChannelStats:
        """Data-plane totals for the whole set: every proxy's entrance
        channels plus every instance's delivery channels.  When the run
        is lock-instrumented (pytest, REPRO_LOCK_CHECK=1), ``lock_stats``
        carries per-lock-name contention counters — acquisitions,
        contended count, total/max wait and hold (docs/static_analysis.md);
        {} in production."""
        total = ChannelStats()
        for p in self.proxies:
            total = total.merge(p.transport_stats())
        for inst in self.instances.values():
            total = total.merge(inst.rd.transport_stats())
        total.lock_stats = lock_stats_snapshot()
        prof = profiler()
        if prof.enabled:
            total.latency = prof.snapshot()
        return total

    def dead_uids(self) -> set:
        """Per-request §9 reconciliation (docs/workflows.md): UIDs any drop
        site tombstoned, plus UIDs stranded mid-join (a sibling branch was
        lost on the wire without its UID ever being decodable).  After the
        set has quiesced, ``submitted == stored ∪ dead_uids()`` — exactly
        one joined result per surviving UID, none partial."""
        return self.joins.dropped_snapshot() | self.joins.pending_uids()

    # ----------------------------------------------------------- lifecycle
    def start(self) -> None:
        for inst in self.instances.values():
            inst.start()
        if self._control_loop:
            self.control = ControlLoop(
                self.nm,
                monitors=lambda: [p.monitor for p in self.proxies
                                  if p.monitor is not None],
                interval_s=self._control_interval_s,
                liveness_timeout_s=self._liveness_timeout_s,
            )
            self.control.start()
        self._started = True

    def stop(self) -> None:
        if self.control is not None:
            self.control.stop()  # kept (stopped) so its audit stats survive
        # Three phases: signal everyone, join everyone, only then drain for
        # terminal accounting — a worker of a later-joined instance could
        # otherwise deliver into an inbox already drained.
        for inst in self.instances.values():
            inst.request_stop()
        for inst in self.instances.values():
            inst.join()
        for inst in self.instances.values():
            inst.drain_terminal()
        # Durability barrier: every queued join-mirror op has reached the
        # database replicas before the set reports itself stopped.
        self.joins.flush_mirror()
        self._started = False

    def __enter__(self) -> "WorkflowSet":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


class MultiSetFrontend:
    """Client-side spreading across Workflow Sets (§3): submit to a random
    set; on fast-reject, try another — failures stay isolated per set."""

    def __init__(self, sets: Sequence[WorkflowSet], seed: int = 0):
        self.sets = list(sets)
        self.rng = random.Random(seed)

    def submit(self, app_id: int, payload: Any) -> tuple:
        order = self.rng.sample(range(len(self.sets)), len(self.sets))
        last_err: Optional[Exception] = None
        for i in order:
            ws = self.sets[i]
            if not ws.proxies:
                continue
            proxy = self.rng.choice(ws.proxies)
            try:
                return ws, proxy.submit(app_id, payload)
            except Rejected as e:
                last_err = e
                continue
        raise last_err or Rejected("no sets available")

    def submit_many(self, app_id: int, payloads: Sequence[Any]) -> List[tuple]:
        """Batched spreading: the burst goes to a random set's proxy via its
        doorbell-batched ``submit_many``; whatever that set fast-rejects or
        drops spills over to the next set.  Returns ``(set, uid)`` pairs
        aligned with the admitted prefix of ``payloads`` — like ``submit``,
        callers poll each UID against the set that admitted it."""
        remaining = list(payloads)
        placed: List[tuple] = []
        last_err: Optional[Exception] = None
        for i in self.rng.sample(range(len(self.sets)), len(self.sets)):
            if not remaining:
                break
            ws = self.sets[i]
            if not ws.proxies:
                continue
            proxy = self.rng.choice(ws.proxies)
            try:
                uids = proxy.submit_many(app_id, remaining)
            except Rejected as e:
                last_err = e
                continue
            placed.extend((ws, u) for u in uids)
            remaining = remaining[len(uids):]
        if not placed and remaining:
            raise last_err or Rejected("no sets available")
        return placed

    def transport_stats(self) -> ChannelStats:
        """Aggregated data-plane totals across every member set — the
        multi-set analogue of ``WorkflowSet.transport_stats``."""
        total = ChannelStats()
        for ws in self.sets:
            total = total.merge(ws.transport_stats())
        return total

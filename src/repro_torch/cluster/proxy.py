"""Proxy (§3.2): client entry point — UID assignment, fast-reject admission,
entrance-stage injection over RDMA, result retrieval by UID.

Entrance injection goes through the unified transport ``Router``: cached
per-target channels, round-robin across entrance instances, bounded-retry
then drop (§9), scatter-gather framing straight to the target ring.

DAG workflows may have several entrance stages (docs/workflows.md): one
admitted request = one UID = one admission token, fanned out as one message
copy per entrance stage.  If any entrance append fails the request is
rejected whole — the UID is tombstoned in the join table so branch copies
that did land can never produce a partial result.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.cluster.database import ReplicatedDatabase
from repro_torch.cluster.join import JoinTable
from repro_torch.cluster.node_manager import NodeManager
from repro_torch.core.messaging import WorkflowMessage
from repro_torch.core.rdma import RdmaFabric
from repro_torch.core.request_monitor import RequestMonitor
from repro_torch.core.ring_buffer import DoubleRingBuffer
from repro_torch.core.transport import ChannelStats, Router


class Rejected(Exception):
    """Fast-reject: client should retry against another Workflow Set."""


class Proxy:
    def __init__(
        self,
        name: str,
        fabric: RdmaFabric,
        nm: NodeManager,
        database: ReplicatedDatabase,
        buffers: Dict[str, DoubleRingBuffer],
        *,
        monitor: Optional[RequestMonitor] = None,
        joins: Optional[JoinTable] = None,
    ):
        self.name = name
        self.fabric = fabric
        self.nm = nm
        self.database = database
        self.buffers = buffers
        self.monitor = monitor
        self.joins = joins
        self.router = Router(name, buffers, nm=nm)
        # Per-topology-epoch entrance routing cache (app_id -> entrance
        # list): exact within an epoch because every NM mutation bumps
        # ``topology_version``; removes the per-submit NM lock round-trips
        # from the admission hot path.  Only successful lookups are cached
        # (a fast-reject is not a steady state worth pinning).
        self._entrance_cache: tuple = (-1, {})
        nm.register_instance(name, role="proxy")

    def _entrances(self, app_id: int) -> List[Tuple[str, int, List[str]]]:
        """Per entrance stage: (name, stage index, live instances).  Raises
        fast-reject if any entrance stage has nowhere to land — a request
        missing a branch could never complete its joins."""
        epoch = self.nm.topology_version()
        cache = self._entrance_cache
        if cache[0] != epoch:
            cache = (epoch, {})
            self._entrance_cache = cache
        out = cache[1].get(app_id)
        if out is not None:
            return out
        wf = self.nm.workflows[app_id]
        out = []
        for stage in wf.entrance_stages():
            instances = self.nm.stage_instances(stage)
            if not instances:
                raise Rejected(
                    f"no instances for entrance stage {stage!r} of app {app_id}")
            out.append((stage, wf.stage_index(stage), instances))
        cache[1][app_id] = out
        return out

    def _mark_dropped(self, uid_hex: str) -> None:
        if self.joins is not None:
            self.joins.mark_dropped(uid_hex)

    def submit(self, app_id: int, payload: Any) -> str:
        """Admit (or fast-reject) a generation request; returns the UID the
        client later polls with.  One message copy is appended per entrance
        stage (the DAG fan-out).  A request dropped at a full entrance ring
        is a *known* terminal drop — its in-flight token is released
        immediately and the UID tombstoned, so branch copies that landed
        before the failure die at their next join (downstream drops are
        invisible to the proxy and only expire via the monitor's TTL)."""
        entrances = self._entrances(app_id)
        if self.monitor is not None and not self.monitor.try_admit():
            raise Rejected(f"proxy {self.name} over admissible rate")
        base = WorkflowMessage.new(app_id=app_id, payload=payload,
                                   stage=entrances[0][1])
        for stage, idx, instances in entrances:
            if self.router.send(instances, base.for_stage(idx),
                                rr_key=("entrance", app_id, stage)) is None:
                self._mark_dropped(base.uid_hex)
                self.complete()  # never (fully) entered the pipeline
                raise Rejected(f"entrance ring full for stage {stage!r}")
        return base.uid_hex

    def submit_many(self, app_id: int, payloads: List[Any]) -> List[str]:
        """Batched admission: one doorbell-batched ring append per entrance
        stage for the whole burst.  Returns UIDs for the prefix that landed
        on *every* entrance branch.  Routing is checked before any
        admission token is consumed; the dropped suffix never (fully)
        entered the pipeline, so its in-flight tokens are released on the
        spot and its UIDs tombstoned (§9 still applies on the wire:
        nothing is retransmitted)."""
        entrances = self._entrances(app_id)
        if self.monitor is not None:
            # Stop at the first rejection so the admitted set is a true
            # prefix of `payloads` — a mid-list reject (in-flight token
            # freed by TTL expiry during the loop) would otherwise leave
            # the caller unable to map returned UIDs back to payloads.
            admitted = []
            for p in payloads:
                if not self.monitor.try_admit():
                    break
                admitted.append(p)
            payloads = admitted
        if not payloads:
            return []
        base = [WorkflowMessage.new(app_id=app_id, payload=p,
                                    stage=entrances[0][1])
                for p in payloads]
        # Each branch's send_many lands a prefix; a request is admitted only
        # if every branch landed it, so the admitted set is the min prefix.
        # Later branches only receive the running-min prefix — copies past
        # it are already doomed to the tombstone, so appending them would
        # waste ring slots and full branch execution.
        n = len(base)
        for stage, idx, instances in entrances:
            msgs = base[:n] if idx == entrances[0][1] else \
                [m.for_stage(idx) for m in base[:n]]
            n = min(n, self.router.send_many(instances, msgs,
                                             rr_key=("entrance", app_id, stage)))
        for m in base[n:]:
            self._mark_dropped(m.uid_hex)
            self.complete()  # entrance-ring drop: token back
        return [m.uid_hex for m in base[:n]]

    def transport_stats(self) -> ChannelStats:
        return self.router.stats()

    def poll_result(self, uid: str) -> Optional[Any]:
        v = self.database.fetch(uid)
        if v is not None:
            # The one success the proxy can observe: the stored result was
            # fetched (and purged), so release its in-flight token instead
            # of leaving it to wedge admission until the TTL reclaims it.
            self.complete()
        return v

    def poll_partial(self, uid: str) -> Optional[Any]:
        """Token-boundary streaming (docs/disaggregation.md): a continuous
        decode stage publishes each request's tokens-so-far under
        ``partial/<uid>`` after every scan segment.  Reads are
        non-destructive (``scan``, not ``fetch``) so repeated polls watch
        the prefix grow; the final result still arrives only through
        ``poll_result``/``wait_result``, and completion purges the partial
        key.  Returns None before the first segment and after completion."""
        hits = self.database.scan(f"partial/{uid}")
        return hits.get(f"partial/{uid}")

    def wait_result(self, uid: str, timeout_s: float = 10.0,
                    interval_s: float = 0.002) -> Any:
        """Event-driven result wait: parks on the database's store doorbell
        and re-polls on every store, instead of sleeping a fixed interval.
        ``interval_s`` survives as the fallback re-poll bound (the store
        signal is shared by all waiters, so one waiter can consume a wake
        meant for another — the bounded wait covers that race)."""
        deadline = time.monotonic() + timeout_s
        while True:
            v = self.poll_result(uid)
            if v is not None:
                return v
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"no result for {uid}")
            self.database.wait_store(min(max(interval_s, 0.0005), remaining))

    def complete(self) -> None:
        if self.monitor is not None:
            self.monitor.complete()

"""Workflow instance (§4): TaskManager + RequestScheduler + TaskWorkers +
ResultDeliver, communicating over the one-sided-RDMA double-ring buffers.

  * TaskManager      — polls the NM for its stage assignment + routing and
                       reports utilization (§4.2).
  * RequestScheduler — watches the instance's inbox memory region and
                       coalesces same-shape requests into microbatches
                       (``max_batch``/``max_wait_s``, shape-bucketed so a
                       batch never mixes jit signatures); Individual Mode
                       pushes batches onto a shared local queue (idle
                       workers fetch — natural load balance), Collaboration
                       Mode broadcasts each batch to every worker (§4.3).
  * TaskWorker       — runs the user-defined stage function once per
                       *batch* (payloads stacked along axis 0); in CM the
                       workers' partial results are aggregated before
                       delivery (§4.4-4.5).
  * ResultDeliver    — splits each batch result back into per-request
                       slices and routes every request under its own UID:
                       round-robin RDMA append to next-hop inboxes (whole
                       batches ride one doorbell-batched append so they
                       re-coalesce downstream); final stage stores into
                       the replicated database (§4.5).

With ``max_batch=1`` (the default) every path is identical to the
pre-batching per-request behavior — stage functions receive the raw
payload, untouched.  With ``max_batch>1`` stage functions must be
batch-aware: they receive one stacked pytree (see repro_torch.core.batching)
and return a result whose array leaves split along axis 0.

Messages lost between stages are NOT retransmitted (§9) — the fast-reject +
transient-result design makes retries worse than drops.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.analysis.runtime import make_lock
from repro_torch.cluster.database import ReplicatedDatabase
from repro_torch.cluster.join import JOIN_DEAD, JOIN_PENDING, JoinTable
from repro_torch.cluster.node_manager import NodeManager
from repro_torch.core.batching import Coalescer, bucket_key, stack_payloads, unstack_payload
from repro_torch.core.messaging import KVPages, WorkflowMessage
from repro_torch.core.profiling import profiler
from repro_torch.core.rdma import RdmaFabric
from repro_torch.core.ring_buffer import CORRUPT, DoubleRingBuffer
from repro_torch.core.streaming import DEFERRED, is_continuous
from repro_torch.core.transport import ChannelStats, Router

_DROP = object()  # per-message failure sentinel inside a batch result


@dataclass
class InstanceStats:
    processed: int = 0       # requests through the stage fn
    delivered: int = 0
    dropped: int = 0
    batches: int = 0         # stage-fn invocations (== processed iff unbatched)
    solo_fallbacks: int = 0  # batches degraded to per-message execution
    handoffs: int = 0        # queued messages forwarded to peers on reassignment
    reassignments: int = 0   # drain-and-handoff cycles completed
    busy_s: float = 0.0
    window_start: float = field(default_factory=time.monotonic)


class ResultDeliver:
    """Delivery to next-hop inboxes over the unified transport Router.

    Routing is per-edge over the workflow DAG (docs/workflows.md): a
    message fans out to every successor stage — each single-dep edge gets
    its own round-robin target and one doorbell-batched append for the
    whole microbatch (so batches re-coalesce downstream); each fan-in edge
    is an ``offer`` into the set-level JoinTable, and the offer that
    completes a join routes the assembled message onward.  After the
    terminal stage results go to the replicated database.  Bounded retries
    on a full ring then drop (§9); drops that know their UID tombstone the
    whole request in the join table so no partial join is ever delivered.
    Cached producers are invalidated whenever the NM reassigns a target
    away from a next-hop set."""

    def __init__(self, fabric: RdmaFabric, name: str, nm: NodeManager,
                 database: Optional[ReplicatedDatabase],
                 buffers: Optional[Dict[str, DoubleRingBuffer]] = None,
                 joins: Optional[JoinTable] = None):
        self.fabric = fabric
        self.name = name
        self.nm = nm
        self.database = database
        self.joins = joins
        self.router = Router(name, buffers if buffers is not None else {}, nm=nm)
        # Per-topology-epoch route cache: (app_id, stage) -> list of
        # (succ, succ_idx, deps, hops).  Every NM mutation bumps
        # ``topology_version`` (register/assign/confirm/evict), so within
        # one epoch the successor sets and live-hop lists are EXACT — the
        # cache removes three NM lock round-trips per message from the
        # delivery hot path.  Swapped atomically as an (epoch, dict)
        # tuple; racing fillers compute identical entries.
        self._route_cache: tuple = (-1, {})

    def _sync_buffers(self, buffers: Optional[Dict[str, DoubleRingBuffer]]) -> None:
        if buffers is not None and buffers is not self.router.buffers:
            self.router.buffers = buffers

    def mark_dropped(self, uid_hex: str) -> None:
        """Per-request §9 ledger: tombstone the UID (and its sibling
        partials) in the join table, if this set has one."""
        if self.joins is not None:
            self.joins.mark_dropped(uid_hex)

    def deliver(self, msg: WorkflowMessage, stage: str,
                buffers: Optional[Dict[str, DoubleRingBuffer]] = None) -> bool:
        return self.deliver_many([msg], stage, buffers) == 1

    def _routes(self, app_id: int, stage: str) -> List[tuple]:
        """Cached per-epoch successor routing for (app, stage): a list of
        ``(succ, succ_idx, deps, hops)``, empty for a terminal stage."""
        epoch = self.nm.topology_version()
        cache = self._route_cache
        if cache[0] != epoch:
            cache = (epoch, {})
            self._route_cache = cache
        routes = cache[1].get((app_id, stage))
        if routes is None:
            wf = self.nm.workflows[app_id]
            routes = [(succ, wf.stage_index(succ), wf.deps_of(succ),
                       self.nm.stage_instances(succ))
                      for succ in wf.successors(stage)]
            cache[1][(app_id, stage)] = routes
        return routes

    def deliver_many(self, msgs: List[WorkflowMessage], stage: str,
                     buffers: Optional[Dict[str, DoubleRingBuffer]] = None) -> int:
        """Deliver a batch's per-request results from `stage`; returns how
        many messages were accepted on *every* successor edge.  All
        messages must belong to one app (the scheduler's bucket key
        guarantees it); `msgs` carry the source stage index.

        ``deliver_many`` OWNS its inputs: on the common single-successor
        edge the messages are re-stamped to the successor's stage index
        *in place* (``WorkflowMessage`` is mutable) instead of paying a
        per-edge ``for_stage`` copy — callers must not reuse the message
        objects afterwards.  Fan-out (>1 successor) still derives one
        copy per extra edge."""
        if not msgs:
            return 0
        self._sync_buffers(buffers)
        app_id = msgs[0].app_id
        routes = self._routes(app_id, stage)
        if not routes:
            # terminal stage -> durable (transient) storage, keyed by UID
            if self.database is None:
                return 0
            ok = 0
            for m in msgs:
                if self.joins is not None and \
                        m.uid_hex in self.joins.dropped_uids:
                    continue  # a sibling edge already dropped this request
                try:
                    self.database.store(m.uid_hex, m.payload)
                except ConnectionError:
                    # every replica down: a known terminal drop, not a
                    # worker-killing error — account it like any other (§9)
                    self.mark_dropped(m.uid_hex)
                    continue
                ok += 1
            return ok
        ok = [True] * len(msgs)
        single = len(routes) == 1
        for succ, idx, deps, hops in routes:
            # A message dropped on an earlier edge is a dead request: do
            # not fan it to the remaining edges — the whole downstream
            # subgraph would run it only for a join/terminal to refuse it.
            live = [i for i in range(len(msgs)) if ok[i]]
            if not live:
                break
            if len(deps) > 1:
                self._offer_fan_in(msgs, live, stage, succ, idx, deps, ok,
                                   hops)
                continue
            # single-dep edge: one round-robin pick, one doorbell-batched
            # append for the whole microbatch
            if single:
                # copy diet: sole successor — re-stamp in place, zero copies
                out = msgs if len(live) == len(msgs) \
                    else [msgs[i] for i in live]
                for m in out:
                    m.stage = idx
            else:
                out = [msgs[i].for_stage(idx) for i in live]
            # KV-cache shipments ride the wire ledger: a silent drop of a
            # bulk writev surfaces only as an undecodable corrupt entry at
            # the consumer, so the sender records the UID first and the
            # receiver settles at unpack (§9 stays per-request exact).
            if self.joins is not None:
                for m in out:
                    if isinstance(m.payload, KVPages):
                        self.joins.track_wire(m.uid_hex)
            n = self._send_edge(hops, out, (app_id, succ))
            for i in live[n:]:
                ok[i] = False
                self.mark_dropped(msgs[i].uid_hex)
        return sum(ok)

    def _send_edge(self, hops: List[str], out: List[WorkflowMessage],
                   rr_key) -> int:
        """One edge's append: a prefix of `out` lands on one round-robin
        target (doorbell-batched for real batches); returns how many."""
        if not hops:
            return 0
        if len(out) == 1:
            return 1 if self.router.send(hops, out[0], rr_key=rr_key) \
                is not None else 0
        return self.router.send_many(hops, out, rr_key=rr_key)

    def _offer_fan_in(self, msgs: List[WorkflowMessage], live: List[int],
                      stage: str, succ: str, idx: int, deps: List[str],
                      ok: List[bool], hops: List[str]) -> None:
        """Fan-in edge: offer each live partial to the join table; joins
        completed by this batch ride one doorbell-batched append to the
        fan-in stage, so microbatches re-coalesce past the join too."""
        app_id = msgs[0].app_id
        if self.joins is None:  # no assembler: partials can never join (§9)
            for i in live:
                ok[i] = False
            return
        completed: List[tuple] = []  # (msg index, assembled message)
        for i in live:
            m = msgs[i]
            res = self.joins.offer(app_id, idx, m.uid_hex, stage,
                                   m.payload, deps)
            if res is JOIN_DEAD:
                ok[i] = False
            elif res is not JOIN_PENDING:
                completed.append((i, m.for_stage(idx, res)))
        if not completed:
            return
        n = self._send_edge(hops, [j for _, j in completed], (app_id, succ))
        for i, _ in completed[n:]:
            ok[i] = False
            self.mark_dropped(msgs[i].uid_hex)

    def transport_stats(self) -> ChannelStats:
        return self.router.stats()


class WorkflowInstance:
    def __init__(
        self,
        name: str,
        fabric: RdmaFabric,
        nm: NodeManager,
        *,
        n_workers: int = 1,
        mode: str = "IM",
        database: Optional[ReplicatedDatabase] = None,
        ring_slots: int = 256,
        ring_bytes: int = 1 << 22,
        poll_interval_s: float = 0.0005,
        max_batch: int = 1,
        max_wait_s: float = 0.002,
        pad_to_full: bool = False,
        buffers: Optional[Dict[str, DoubleRingBuffer]] = None,
        joins: Optional[JoinTable] = None,
        event_driven: bool = True,
        report_interval_s: Optional[float] = None,
        inline: bool = False,
    ):
        self.name = name
        self.fabric = fabric
        self.nm = nm
        self.n_workers = n_workers
        self.mode = mode
        self.poll_interval_s = poll_interval_s
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.event_driven = event_driven
        # Utilization reports are control traffic: each one is a replicated
        # NM write, so they are throttled way below the data-plane poll
        # cadence (the old poll_interval_s*4 put ~500 writes/s/instance on
        # the NM lock).
        self.report_interval_s = (
            report_interval_s if report_interval_s is not None
            else max(poll_interval_s * 4, 0.02))
        # Pad deadline-flushed partial batches up to max_batch (repeating
        # the tail request) so a jitted stage fn only ever sees one batch
        # shape per bucket — a 3-request flush would otherwise trigger a
        # fresh XLA compile worth seconds on its first appearance.
        self.pad_to_full = pad_to_full
        self.inbox = DoubleRingBuffer(
            fabric, f"{name}.inbox", n_slots=ring_slots, buf_size=ring_bytes,
            consumer_id=name,
        )
        self.buffers = buffers if buffers is not None else {}
        self.buffers[name] = self.inbox
        self.rd = ResultDeliver(fabric, name, nm, database, self.buffers,
                                joins=joins)
        self.stats = InstanceStats()
        self._queue: "queue.Queue[List[WorkflowMessage]]" = queue.Queue()
        self._stop = threading.Event()
        # Event-driven wakeup (doorbell-notify): producers fire the inbox's
        # notify hook strictly after the ring lock is released; the
        # scheduler waits on this event instead of sleep-polling, so an
        # idle hop wakes in scheduler-latency time, not poll_interval_s.
        # Waiters clear-then-repoll, so a doorbell set between the empty
        # poll and the wait is never lost.
        self._doorbell = threading.Event()
        if event_driven:
            self.inbox.set_notify(self._doorbell.set)
        # Opt-in: single-worker IM instances can run the stage fn inline on
        # the scheduler thread — no queue handoff, no worker thread, two
        # fewer context switches per hop.  The trade: the scheduler is also
        # the drain-and-handoff agent, so a stage fn that blocks delays
        # reassignment adoption until it returns.  Off by default to keep
        # the control plane preemptive under stuck workers; serving setups
        # with pure-compute stage fns turn it on.  CM keeps its broadcast
        # path regardless.
        self._inline = inline and mode != "CM" and n_workers == 1
        # Event-driven schedulers park long when idle — the doorbell wakes
        # them, so the timeout is only a liveness backstop; polling
        # schedulers keep the classic short nap.
        self._idle_wait_s = max(0.05, poll_interval_s) if event_driven \
            else poll_interval_s
        # Adaptive-flush grace: how long a partial bucket may sit
        # unchanged with an empty inbox before it is flushed early —
        # far below max_wait_s, just wide enough to ride out the
        # producer-side gap between back-to-back appends.
        self._flush_grace_s = min(max_wait_s * 0.5,
                                  max(poll_interval_s * 8, 0.002))
        # Per-topology-epoch (app_id, stage_idx) -> (stage name, fn | None)
        # cache — same exactness argument as ResultDeliver._routes.
        self._stage_cache: tuple = (-1, {})
        # Continuous-stage protocol (repro_torch.core.streaming): messages a
        # continuous stage fn absorbed (returned DEFERRED for) — parked
        # under their UID until a scheduler tick emits their result, and
        # accounted as dropped if the instance drains first.  Written by
        # whichever thread ran the stage fn, read by the scheduler pump.
        self._deferred: Dict[str, WorkflowMessage] = {}  # guarded_by: _cont_lock
        self._cont_lock = make_lock("WorkflowInstance._cont_lock")
        self._threads: List[threading.Thread] = []
        self._stage: Optional[str] = None
        self._version = -1
        # (stage, version) observed by the manager but not yet applied — the
        # scheduler thread (sole inbox consumer) performs the drain-and-
        # handoff, then adopts it and confirms to the NM.
        self._pending: Optional[tuple] = None
        nm.register_instance(name, role="workflow", location=f"{name}.inbox")

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        self._refresh_assignment()
        self._threads = [
            threading.Thread(target=self._scheduler_loop, daemon=True,
                             name=f"{self.name}-rs")
        ]
        if not self._inline:  # inline mode: the scheduler thread executes
            for i in range(self.n_workers):
                self._threads.append(
                    threading.Thread(target=self._worker_loop, args=(i,),
                                     daemon=True, name=f"{self.name}-w{i}")
                )
        self._threads.append(
            threading.Thread(target=self._manager_loop, daemon=True,
                             name=f"{self.name}-tm")
        )
        for t in self._threads:
            t.start()

    def request_stop(self) -> None:
        """Signal the threads without waiting (WorkflowSet.stop signals the
        whole set first, so no instance keeps delivering into inboxes that
        were already drained for terminal accounting)."""
        self._stop.set()
        self._doorbell.set()  # wake a scheduler parked on the doorbell

    def stop(self) -> None:
        self.request_stop()
        self.join()
        self.drain_terminal()

    def join(self) -> None:
        for t in self._threads:
            t.join(timeout=2.0)

    def _mark_dropped_msgs(self, msgs: List[WorkflowMessage]) -> None:
        for m in msgs:
            self.rd.mark_dropped(m.uid_hex)

    def drain_terminal(self) -> None:
        """Terminal accounting: whatever is still sitting in the worker queue
        or the inbox after the threads exit was admitted but will never be
        processed — count every message so `submitted == stored + dropped`
        holds across the set (§9: drops are fine, silent isn't).  Call only
        after every instance that could deliver here has joined — a still-
        running upstream worker could otherwise land a message after the
        drain, counted delivered but never processed."""
        while True:
            try:
                batch = self._queue.get_nowait()
            except queue.Empty:
                break
            self.stats.dropped += len(batch)
            self._mark_dropped_msgs(batch)
        while True:
            item = self.inbox.poll()
            if item is None:
                break
            self.stats.dropped += 1
            if not isinstance(item, type(CORRUPT)):
                try:  # best-effort UID ledger (corrupt entries carry none)
                    self.rd.mark_dropped(WorkflowMessage.unpack(item).uid_hex)
                except Exception:
                    pass
        # Requests a continuous stage absorbed but never finished: release
        # their slots and tombstone them — a parked decode request must end
        # up in dead_uids(), never silently stranded in a slot (§9).
        with self._cont_lock:
            leftover = list(self._deferred.items())
            self._deferred.clear()
        abandoned: set = set()
        for uid, m in leftover:
            fn = self._stage_callable(m)
            if fn is not None and is_continuous(fn) and id(fn) not in abandoned:
                abandoned.add(id(fn))
                try:
                    fn.abandon()
                except Exception:
                    pass
            self.stats.dropped += 1
            self.rd.mark_dropped(uid)

    # ------------------------------------------------------------ manager
    def _refresh_assignment(self) -> None:
        """Startup path: adopt the assignment directly (nothing queued yet)."""
        stage, version = self.nm.get_assignment(self.name)
        if version != self._version:
            self._stage, self._version = stage, version

    def _poll_assignment(self) -> None:
        """Steady-state path: a changed assignment is staged in ``_pending``
        for the scheduler thread, which owns the drain-and-handoff."""
        stage, version = self.nm.get_assignment(self.name)
        if version != self._version:
            pending = self._pending
            if pending is None or pending[1] != version:
                self._pending = (stage, version)

    def _manager_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._poll_assignment()
            except KeyError:
                # Evicted by the liveness sweep while still alive (missed
                # reports): the next utilization report re-registers us into
                # the idle pool; keep the manager thread up meanwhile.
                pass
            now = time.monotonic()
            span = max(now - self.stats.window_start, 1e-6)
            util = min(self.stats.busy_s / (span * self.n_workers), 1.0)
            self.nm.report_utilization(self.name, util)
            if span > 2.0:
                self.stats.busy_s = 0.0
                self.stats.window_start = now
            self._stop.wait(self.report_interval_s)

    # ----------------------------------------------------------- scheduler
    def _dispatch(self, batch: List[WorkflowMessage]) -> None:
        prof = profiler()
        if prof.enabled:
            t = time.monotonic()
            for m in batch:
                prof.stamp(m.uid_hex, m.stage, "dispatch", t=t)
        if self.mode == "CM":
            self._run_cm(batch)  # broadcast: all workers on one batch
        elif self._inline:
            self._process_batch(batch)  # single worker: run on this thread
        else:
            self._queue.put(batch)  # IM: shared queue, workers pull

    # ------------------------------------------------- drain-and-handoff
    def _unpack_inbox_backlog(self) -> List[WorkflowMessage]:
        """Poll the inbox dry, decoding entries (corrupt ones accounted)."""
        msgs: List[WorkflowMessage] = []
        while True:
            item = self.inbox.poll()
            if item is None:
                return msgs
            if isinstance(item, type(CORRUPT)):
                self.stats.dropped += 1
                continue
            try:
                m = WorkflowMessage.unpack(item)
            except Exception:
                self.stats.dropped += 1
                continue
            if isinstance(m.payload, KVPages) and self.rd.joins is not None:
                self.rd.joins.settle_wire(m.uid_hex)
            msgs.append(m)

    def _apply_reassignment(self, coalescer: Coalescer) -> None:
        """Adopt a pending reassignment (scheduler thread only).

        Every queued message — coalescer buckets, the worker queue, the
        unpolled inbox backlog — still belongs to the *old* stage.  Each is
        handed off to a live peer of its own stage; if none exists (or the
        peer's ring is full) it is kept and executed locally, which is still
        correct because workers resolve the stage fn from the message's own
        stage index, never from ``self._stage``.  Only after the drain does
        the instance confirm to the NM, re-entering routing under the new
        stage."""
        pending = self._pending
        if pending is None:
            return
        self._pending = None
        new_stage, version = pending
        leftovers: List[WorkflowMessage] = []
        for _, batch in coalescer.flush_all():
            leftovers.extend(batch)
        while True:
            try:
                leftovers.extend(self._queue.get_nowait())
            except queue.Empty:
                break
        leftovers.extend(self._unpack_inbox_backlog())
        for msg in leftovers:
            stage = self._stage_name_of(msg)
            peers = [t for t in (self.nm.stage_instances(stage) if stage else [])
                     if t != self.name]
            if peers and self.rd.router.send(
                    peers, msg, rr_key=("handoff", msg.app_id, msg.stage)
            ) is not None:
                self.stats.handoffs += 1
            else:
                self._dispatch([msg])  # no live peer: run it here, correctly
        self._stage, self._version = new_stage, version
        self.stats.reassignments += 1
        self.nm.confirm_reassignment(self.name)

    def _wait_for_traffic(self, timeout: float) -> None:
        """Park until the inbox doorbell rings (event-driven) or `timeout`
        passes.  Clear-then-repoll discipline: a doorbell set between the
        caller's empty poll and this wait is observed here (fast return);
        one set *during* the wait wakes it; a stale doorbell just costs
        one extra poll.  No interleaving loses a wakeup."""
        if not self.event_driven:
            self._stop.wait(timeout)
            return
        if self._doorbell.is_set():
            self._doorbell.clear()
            return  # traffic landed since the last poll: repoll now
        self._doorbell.wait(timeout)
        self._doorbell.clear()

    def _pump_continuous(self) -> bool:
        """Tick every continuous stage fn holding parked messages: one tick
        runs one decode segment and may complete requests, whose results
        are delivered here under their original message identity.  Returns
        True while any fn still has work in flight — the scheduler must
        then keep alternating poll/tick (each inbox poll between ticks IS
        the token-boundary admission window) instead of parking."""
        with self._cont_lock:
            if not self._deferred:
                return False
            parked = dict(self._deferred)
        by_fn: Dict[int, tuple] = {}
        for uid, m in parked.items():
            fn = self._stage_callable(m)
            if fn is None or not is_continuous(fn):
                # stage vanished from the topology: the parked request can
                # never complete — account it, never strand it silently
                with self._cont_lock:
                    if self._deferred.pop(uid, None) is not None:
                        self.stats.dropped += 1
                        self.rd.mark_dropped(uid)
                continue
            by_fn.setdefault(id(fn), (fn, []))[1].append(uid)
        pending = False
        for fn, uids in by_fn.values():
            t0 = time.monotonic()
            try:
                done = fn.tick()
            except Exception:
                # a dying decode batch: abandon every resident request of
                # this fn with §9 accounting rather than kill the scheduler
                try:
                    fn.abandon()
                except Exception:
                    pass
                done = [(u, _DROP) for u in uids]
            self.stats.busy_s += time.monotonic() - t0
            for uid, result in done:
                with self._cont_lock:
                    m = self._deferred.pop(uid, None)
                if m is None:
                    continue  # already accounted (drain/reassign race)
                self._deliver_results([m], [result])
            try:
                if fn.pending() > 0:
                    pending = True
            except Exception:
                pass
        return pending

    def _scheduler_loop(self) -> None:
        coalescer = Coalescer(max_batch=self.max_batch, max_wait_s=self.max_wait_s)
        # max_batch=1 instances bypass the coalescer entirely: no bucket
        # bookkeeping, no deadline arithmetic — poll, unpack, dispatch.
        bypass = self.max_batch <= 1
        prof = profiler()
        while not self._stop.is_set():
            self._apply_reassignment(coalescer)
            cont_busy = self._pump_continuous()
            item = self.inbox.poll()
            if item is None:
                if cont_busy:
                    continue  # slots still decoding: tick again, don't park
                if bypass:
                    self._wait_for_traffic(self._idle_wait_s)
                    continue
                for _, batch in coalescer.pop_expired():
                    self._dispatch(batch)
                # adaptive flush: the inbox is empty, so a bucket that saw
                # no traffic for a short grace window is done growing —
                # flush it now instead of waiting out max_wait_s
                flushed, grace_deadline = coalescer.pop_idle(
                    self._flush_grace_s)
                for _, batch in flushed:
                    self._dispatch(batch)
                timeout = self._idle_wait_s
                for dl in (coalescer.next_deadline(), grace_deadline):
                    if dl is not None:
                        timeout = min(timeout,
                                      max(dl - time.monotonic(), 0.0))
                self._wait_for_traffic(timeout)
                continue
            if isinstance(item, type(CORRUPT)):
                self.stats.dropped += 1  # checksum-failed entry, no retry (§9)
                continue
            try:
                msg = WorkflowMessage.unpack(item)
            except Exception:
                self.stats.dropped += 1
                continue
            if isinstance(msg.payload, KVPages) and self.rd.joins is not None:
                self.rd.joins.settle_wire(msg.uid_hex)  # KV ship arrived
            if prof.enabled:
                prof.stamp(msg.uid_hex, msg.stage, "dequeue")
            if bypass:
                self._dispatch([msg])
                continue
            try:
                key = (msg.app_id, msg.stage, bucket_key(msg.payload))
            except TypeError:
                self._dispatch([msg])  # unbatchable payload: run solo
                continue
            full = coalescer.add(key, msg)
            if full is not None:
                self._dispatch(full)
            for _, batch in coalescer.pop_expired():
                self._dispatch(batch)
        # Shutdown: residual partial buckets are dropped with accounting —
        # workers are exiting on the same stop event, so dispatching them
        # would only lose them silently (§9: drops are fine, silent isn't).
        for _, batch in coalescer.flush_all():
            self.stats.dropped += len(batch)
            self._mark_dropped_msgs(batch)

    # ------------------------------------------------------------- workers
    def _stage_entry(self, msg: WorkflowMessage) -> tuple:
        """Per-epoch cached ``(stage name, stage fn | None)`` for the stage
        a message *carries* — two NM lock round-trips per message become
        one dict hit.  Exact within an epoch: workflow registration and
        every reassignment bump ``topology_version``."""
        epoch = self.nm.topology_version()
        cache = self._stage_cache
        if cache[0] != epoch:
            cache = (epoch, {})
            self._stage_cache = cache
        key = (msg.app_id, msg.stage)
        ent = cache[1].get(key)
        if ent is None:
            try:
                name = self.nm.stage_name(msg.app_id, msg.stage)
            except (KeyError, IndexError):
                name = None
            fn = None
            if name is not None:
                try:
                    fn = self.nm.stage_fn(msg.app_id, name).fn
                except KeyError:
                    fn = None
            ent = (name, fn)
            cache[1][key] = ent
        return ent

    def _stage_name_of(self, msg: WorkflowMessage) -> Optional[str]:
        """The stage a message *carries* (its stage index resolved against
        its app's workflow) — the only stage identity execution and routing
        may use.  ``self._stage`` is mutable under reassignment; a queued
        batch must never execute under the stage the instance was
        reassigned *to*."""
        return self._stage_entry(msg)[0]

    def _stage_callable(self, msg: WorkflowMessage) -> Optional[Callable]:
        return self._stage_entry(msg)[1]

    def _stack_batch(self, msgs: List[WorkflowMessage]):
        """Shared singleton/stacking policy for IM and CM: returns
        ``(payload, sizes)`` where sizes is None for the legacy raw-payload
        singleton path (so non-batch-aware stage fns keep working at
        max_batch=1).  ``pad_to_full`` forces even singletons through the
        stacked path so a bucket only ever traces one jit shape."""
        if len(msgs) == 1 and not (self.pad_to_full and self.max_batch > 1):
            return msgs[0].payload, None
        pad = self.max_batch if self.pad_to_full else None
        return stack_payloads([m.payload for m in msgs], pad_to=pad)

    def _run_batch(self, fn: Callable, msgs: List[WorkflowMessage]) -> List[Any]:
        """One stage-fn invocation for a (possibly singleton) batch.  If
        the stacked call fails (stack/unstack infrastructure error, or a
        stage fn that can't take this batch), each message retries solo —
        counted in ``solo_fallbacks`` so a silently-degraded "batched"
        deployment is visible in the stats.  Per-message failures yield
        the _DROP sentinel."""
        if is_continuous(fn):
            # Continuous stages absorb per message (the admission side of
            # the protocol) and typically return DEFERRED; their real
            # results surface later through the scheduler pump.
            results = []
            for m in msgs:
                try:
                    results.append(fn(m.payload, uid=m.uid_hex))
                except Exception:
                    results.append(_DROP)
            return results
        sizes = None
        try:
            payload, sizes = self._stack_batch(msgs)
            if sizes is None:
                return [fn(payload)]
            return unstack_payload(fn(payload), sizes)
        except Exception:
            if sizes is None and len(msgs) == 1:
                return [_DROP]  # the raw call itself failed; a retry is identical
        self.stats.solo_fallbacks += 1
        results = []
        for m in msgs:  # solo fallback
            try:
                results.append(fn(m.payload))
            except Exception:
                results.append(_DROP)
        return results

    def _process_batch(self, msgs: List[WorkflowMessage]) -> None:
        """Execute + deliver one batch — the body shared by the worker
        threads and the inline (single-worker IM) scheduler path."""
        fn = self._stage_callable(msgs[0])
        if fn is None:
            self.stats.dropped += len(msgs)
            self._mark_dropped_msgs(msgs)
            return
        prof = profiler()
        t0 = time.monotonic()
        if prof.enabled:
            for m in msgs:
                prof.stamp(m.uid_hex, m.stage, "fn_start", t=t0)
        results = self._run_batch(fn, msgs)
        t1 = time.monotonic()
        if prof.enabled:
            for m in msgs:
                prof.stamp(m.uid_hex, m.stage, "fn_end", t=t1)
        self.stats.busy_s += t1 - t0
        self.stats.batches += 1
        self._deliver_results(msgs, results)

    def _worker_loop(self, widx: int) -> None:
        while not self._stop.is_set():
            try:
                msgs = self._queue.get(timeout=self.poll_interval_s)
            except queue.Empty:
                continue
            self._process_batch(msgs)

    def _deliver_results(self, msgs: List[WorkflowMessage],
                         results: List[Any]) -> None:
        for m, r in zip(msgs, results):
            if r is _DROP:
                self.stats.dropped += 1
                self.rd.mark_dropped(m.uid_hex)
            elif r is DEFERRED:
                # absorbed by a continuous stage: park under the UID (not
                # processed yet — the pump delivers and counts it later)
                with self._cont_lock:
                    self._deferred[m.uid_hex] = m
                self._doorbell.set()  # wake a parked scheduler to pump
        pairs = [(m, r) for m, r in zip(msgs, results)
                 if r is not _DROP and r is not DEFERRED]
        self.stats.processed += len(pairs)
        if not pairs:
            return
        # Route by the stage the batch was executed under (the messages'
        # own stage — the bucket key pins one (app, stage) per batch), not
        # by self._stage: a reassignment between execution and delivery
        # must not re-aim the results at the new stage's next hops.
        stage = self._stage_name_of(pairs[0][0])
        if stage is None:
            self.stats.dropped += len(pairs)
            self._mark_dropped_msgs([m for m, _ in pairs])
            return
        # Keep the source stage index: ResultDeliver advances each edge's
        # stage index itself (in place for the sole-successor case, via
        # per-edge copies on fan-out), so results must not be pre-advanced
        # to any particular next index here.  The `out` copies carry the
        # new payloads; `pairs` keeps the originals (source stage intact)
        # for the profiler's `delivered` stamp below.
        out = [m.for_stage(m.stage, r) for m, r in pairs]
        if len(out) == 1:
            ok = 1 if self.rd.deliver(out[0], stage, self.buffers) else 0
        else:
            ok = self.rd.deliver_many(out, stage, self.buffers)
        self.stats.delivered += ok
        self.stats.dropped += len(out) - ok
        prof = profiler()
        if prof.enabled:
            t = time.monotonic()
            for m, _ in pairs:
                prof.stamp(m.uid_hex, m.stage, "delivered", label=stage, t=t)

    def _run_cm(self, msgs: List[WorkflowMessage]) -> None:
        """Collaboration Mode: every worker gets the same (stacked) input
        (think TP/PP shards); partials are aggregated into one output, then
        split back into per-request slices for delivery."""
        fn = self._stage_callable(msgs[0])
        if fn is None:
            self.stats.dropped += len(msgs)
            self._mark_dropped_msgs(msgs)
            return
        try:
            payload, sizes = self._stack_batch(msgs)
        except Exception:
            self.stats.dropped += len(msgs)
            self._mark_dropped_msgs(msgs)
            return
        partials: List[Any] = [None] * self.n_workers
        errors: List[bool] = [False] * self.n_workers
        t0 = time.monotonic()

        def run(i):
            try:
                partials[i] = fn(payload, worker_idx=i, n_workers=self.n_workers)
            except Exception:
                errors[i] = True

        threads = [threading.Thread(target=run, args=(i,)) for i in range(self.n_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self.stats.busy_s += (time.monotonic() - t0) * self.n_workers
        if any(errors):
            self.stats.dropped += len(msgs)
            self._mark_dropped_msgs(msgs)
            return
        self.stats.batches += 1
        try:
            combined = _combine_partials(partials)
            results = [combined] if sizes is None else unstack_payload(combined, sizes)
        except Exception:
            # aggregation/split failed (shards disagree on shape/keys):
            # account the drop rather than killing the scheduler thread —
            # _run_cm executes inline in _scheduler_loop.
            self.stats.dropped += len(msgs)
            self._mark_dropped_msgs(msgs)
            return
        self._deliver_results(msgs, results)


def _combine_partials(partials: List[Any]):
    """Default CM aggregation: concatenate array leaves over the shard
    (last) axis, recursing through dict/list/tuple pytrees; non-array
    leaves (scalars, strings) must agree across workers and pass through.
    The batch axis (axis 0) is untouched, so a stacked microbatch stays
    per-request splittable after aggregation."""
    import numpy as np

    if len(partials) == 1:
        return partials[0]
    head = partials[0]
    if isinstance(head, np.ndarray) and head.ndim >= 1:
        return np.concatenate(partials, axis=-1)
    if isinstance(head, dict):
        return {k: _combine_partials([p[k] for p in partials]) for k in head}
    if isinstance(head, (list, tuple)):
        return type(head)(
            _combine_partials([p[i] for p in partials]) for i in range(len(head))
        )
    return head

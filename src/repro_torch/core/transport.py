"""Unified data plane: Channel / Router over the double-ring buffers.

Every sender in the system — the proxy injecting entrance-stage requests
(§3.2) and each instance's ResultDeliver pushing to next-hop inboxes (§4.5)
— used to carry its own copy of the same loop: cache a ``RingProducer`` per
target, round-robin across candidates, bounded-retry on a full ring, then
drop (§9: lost messages are NOT retransmitted; fast-reject + transient
results make retries worse than drops).  This module is that loop, once.

  * ``Channel``  — one cached producer endpoint to one target ring.  Sends
                   are scatter-gather (``WorkflowMessage.pack_parts`` ->
                   ``RingProducer.append`` -> fabric ``writev``): header and
                   tensor payloads flow to the ring with no intermediate
                   Python blob.  ``send_many`` rides the doorbell-batched
                   ``RingProducer.append_many`` (one lock acquire + one
                   tail-header update amortized over the batch).
  * ``Router``   — target selection (round-robin per routing key) plus the
                   channel cache.  The cache is invalidated whenever the
                   NodeManager's topology version moves (an instance was
                   reassigned away from a next-hop set), so producers to
                   stale targets never accumulate.

Layering: verbs (rdma) -> ring (ring_buffer) -> channel/router (here) ->
proxy / instance (cluster).  This module deliberately knows nothing about
the cluster package: the directory object is duck-typed (anything with a
``topology_version()``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Sequence

from repro_torch.analysis.runtime import make_lock
from repro_torch.core.messaging import KVPages, WorkflowMessage
from repro_torch.core.profiling import profiler
from repro_torch.core.ring_buffer import DoubleRingBuffer, PartsLike, RingProducer


@dataclass
class ChannelStats:
    sent: int = 0
    dropped: int = 0
    retries: int = 0
    bytes_sent: int = 0
    batches: int = 0
    # KV-page shipments (the prefill->decode edge of llm_disagg,
    # docs/disaggregation.md): messages whose payload is a KVPages cache
    # shipment, and the raw cache bytes inside them
    kv_pages: int = 0
    kv_bytes: int = 0
    # per-lock-name contention stats (repro_torch.analysis.runtime.LockStats
    # dicts); populated by WorkflowSet.transport_stats() when the suite
    # runs with lock instrumentation, {} otherwise
    lock_stats: Dict[str, dict] = field(default_factory=dict)
    # per-stage phase percentiles (repro_torch.core.profiling snapshot);
    # populated by WorkflowSet.transport_stats() when the profiler is
    # enabled, {} otherwise
    latency: Dict[str, dict] = field(default_factory=dict)

    def merge(self, other: "ChannelStats") -> "ChannelStats":
        return ChannelStats(
            sent=self.sent + other.sent,
            dropped=self.dropped + other.dropped,
            retries=self.retries + other.retries,
            bytes_sent=self.bytes_sent + other.bytes_sent,
            batches=self.batches + other.batches,
            kv_pages=self.kv_pages + other.kv_pages,
            kv_bytes=self.kv_bytes + other.kv_bytes,
            lock_stats={**self.lock_stats, **other.lock_stats},
            latency={**self.latency, **other.latency},
        )


class Channel:
    """A producer endpoint to one target ring with the §9 drop policy:
    bounded retries on a full ring, then the message is dropped (never
    retransmitted)."""

    def __init__(
        self,
        producer: RingProducer,
        target: str,
        *,
        max_retries: int = 64,
        retry_interval_s: float = 0.0005,
    ):
        self.producer = producer
        self.target = target
        self.max_retries = max_retries
        self.retry_interval_s = retry_interval_s
        self._lock = make_lock("Channel._lock")
        self.stats = ChannelStats()  # guarded_by: _lock

    def send_parts(self, parts: PartsLike) -> bool:
        nbytes = (
            len(parts)
            if isinstance(parts, (bytes, bytearray, memoryview))
            else sum(len(p) for p in parts)
        )
        # The retry/append loop runs UNLOCKED.  Holding a Python lock across
        # a ring append or the retry sleep (as this loop originally did)
        # stalls every other worker sharing the channel — and a sender
        # descheduled mid-append while holding the §6.1 ring lock looks dead
        # to its peers, inviting a takeover and the Case-2 same-size clobber.
        # Concurrent appends on one producer are safe: the ring lock
        # serializes them and _new_token hands out distinct tokens.
        for attempt in range(self.max_retries):
            if self.producer.append(parts):
                with self._lock:
                    self.stats.sent += 1
                    self.stats.retries += attempt
                    self.stats.bytes_sent += nbytes
                return True
            time.sleep(self.retry_interval_s)
        with self._lock:
            self.stats.retries += self.max_retries
            self.stats.dropped += 1
        return False

    def send(self, msg: WorkflowMessage) -> bool:
        ok = self.send_parts(msg.pack_parts())
        if ok:
            if isinstance(msg.payload, KVPages):
                with self._lock:
                    self.stats.kv_pages += 1
                    self.stats.kv_bytes += msg.payload.nbytes
            prof = profiler()
            if prof.enabled:
                prof.stamp(msg.uid_hex, msg.stage, "enqueue")
        return ok

    def send_many(self, msgs: Sequence[WorkflowMessage]) -> int:
        """Doorbell-batched send; returns how many messages were appended.
        Retries apply to the *remainder* of the batch, then the rest is
        dropped (§9)."""
        parts = [m.pack_parts() for m in msgs]
        done = 0
        retries = 0
        # Unlocked for the same reason as send_parts; interleaved batches
        # from two workers are each internally ordered, which is all §4.5
        # requires (per-uid order comes from the per-key round-robin).
        for _attempt in range(self.max_retries):
            n = self.producer.append_many(parts[done:])
            done += n
            if done >= len(parts):
                break
            retries += 1
            time.sleep(self.retry_interval_s)
        nbytes = sum(sum(len(x) for x in p) for p in parts[:done])
        kv = [m.payload for m in msgs[:done]
              if isinstance(m.payload, KVPages)]
        with self._lock:
            self.stats.batches += 1
            self.stats.retries += retries
            self.stats.sent += done
            self.stats.dropped += len(parts) - done
            self.stats.bytes_sent += nbytes
            self.stats.kv_pages += len(kv)
            self.stats.kv_bytes += sum(p.nbytes for p in kv)
        prof = profiler()
        if prof.enabled:
            t = time.monotonic()
            for m in msgs[:done]:
                prof.stamp(m.uid_hex, m.stage, "enqueue", t=t)
        return done


class Router:
    """Next-hop selection + per-target channel cache for one sender."""

    def __init__(
        self,
        name: str,
        buffers: Dict[str, DoubleRingBuffer],
        *,
        nm=None,
        producer_id: Optional[int] = None,
        max_retries: int = 64,
        retry_interval_s: float = 0.0005,
    ):
        self.name = name
        self.buffers = buffers
        self.nm = nm
        self.producer_id = (
            producer_id if producer_id is not None else abs(hash(name)) % (1 << 20)
        )
        self.max_retries = max_retries
        self.retry_interval_s = retry_interval_s
        self._lock = make_lock("Router._lock")
        self._channels: Dict[str, Channel] = {}  # guarded_by: _lock
        self._rr: Dict[Hashable, int] = {}  # guarded_by: _lock
        self._topology_version = -1  # guarded_by: _lock
        self._retired = ChannelStats()  # stats of evicted; guarded_by: _lock

    # ------------------------------------------------------------- channels
    def _sync_topology_locked(self) -> None:
        """Drop every cached producer when the NM reassigns anything: a
        target may have left a next-hop set, and a stale producer would
        otherwise live forever (producers are stateless and cheap to
        recreate)."""
        if self.nm is None:
            return
        version = self.nm.topology_version()
        if version != self._topology_version:
            for ch in self._channels.values():
                self._retired = self._retired.merge(ch.stats)
            self._channels.clear()
            self._topology_version = version

    def channel(self, target: str) -> Channel:
        with self._lock:
            self._sync_topology_locked()
            ch = self._channels.get(target)
            if ch is None:
                # Salt the producer id with the topology epoch: an evicted
                # channel may still be mid-send in another thread, and a
                # recreated producer with the same id would restart its
                # nonce — two live producers could then hold identical lock
                # tokens and both "win" a takeover CAS.  Distinct per-epoch
                # ids keep token streams disjoint (modulo the same 2^20
                # birthday odds the seed already accepted between senders).
                pid = (self.producer_id
                       + (self._topology_version + 1) * 0x9E3779B1) % (1 << 20)
                ch = Channel(
                    RingProducer(self.buffers[target], pid, client=self.name),
                    target,
                    max_retries=self.max_retries,
                    retry_interval_s=self.retry_interval_s,
                )
                self._channels[target] = ch
            return ch

    def evict(self, target: str) -> None:
        with self._lock:
            ch = self._channels.pop(target, None)
            if ch is not None:
                self._retired = self._retired.merge(ch.stats)

    def cached_targets(self) -> List[str]:
        with self._lock:
            return list(self._channels)

    # ------------------------------------------------------------- routing
    def select(self, targets: Sequence[str], rr_key: Hashable = None) -> Optional[str]:
        """Round-robin pick among `targets`, advancing the per-key cursor."""
        if not targets:
            return None
        with self._lock:
            idx = self._rr.get(rr_key, -1) + 1
            self._rr[rr_key] = idx
        return targets[idx % len(targets)]

    def send(
        self,
        targets: Sequence[str],
        msg: WorkflowMessage,
        rr_key: Hashable = None,
    ) -> Optional[str]:
        """Round-robin + bounded-retry + drop.  Returns the target that
        accepted the message, or None if it was dropped (§9)."""
        target = self.select(targets, rr_key)
        if target is None:
            return None
        if self.channel(target).send(msg):
            return target
        return None

    def send_many(
        self,
        targets: Sequence[str],
        msgs: Sequence[WorkflowMessage],
        rr_key: Hashable = None,
    ) -> int:
        """Batched variant: the whole batch goes to one round-robin-selected
        target so the doorbell batching can amortize the lock."""
        target = self.select(targets, rr_key)
        if target is None:
            return 0
        return self.channel(target).send_many(msgs)

    # --------------------------------------------------------------- stats
    def stats(self) -> ChannelStats:
        with self._lock:
            total = self._retired
            for ch in self._channels.values():
                total = total.merge(ch.stats)
            return total

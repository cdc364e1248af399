"""The OnePiece double-ring buffer (§6.1) — multi-producer / single-consumer,
variable-size messages, deadlock-free without CPU involvement on the
receiver side.

Structure (one registered RDMA region):

    [ lock | header | size region (ring #2) | buffer region (ring #1) ]

  * lock       — 8B word updated only with one-sided CAS; a non-zero value is
                 an acquisition token ``(producer_id << 24) | nonce``.
                 Producers that observe the same token for longer than the
                 timeout perform a CAS takeover (the paper's TL event).
  * header     — tail_buf / tail_slot (producer side, updated under the lock)
                 and head_buf / head_slot (consumer side).  Monotonic u64
                 counters; ring positions are ``counter % region_size``.
  * size region— ring of 8-byte slots: ``(busy << 63) | entry_size``.  A slot
                 is claimed with CAS(0 -> word): a delayed producer whose
                 entry was overtaken loses the CAS and aborts (Cases 2-6).
                 Only the consumer clears the busy bit (Theorem 2).
  * buffer     — ring of raw bytes holding entries; each entry carries its own
                 16B data header ``magic | payload_len | payload_crc | hdr_crc``
                 so the consumer can detect corruption from delayed
                 overwrites and discard at most that one entry (§6.1
                 "Deadlock and Liveness").

Wrap rule (both sides, deterministic): an entry never straddles the region
end; if it does not fit contiguously the writer skips the tail fragment and
starts at offset 0.  The consumer applies the same rule, so it follows the
same logical path as every successful writer (Theorem 2).

The producer append is exposed both as a plain call and as an explicit
state machine (`AppendOp`) whose steps are the paper's atomic actions
Lock/GH/WB/WL/UH/Unlock — the liveness tests interleave two machines to
reproduce Cases 1-8 verbatim.
"""
from __future__ import annotations

import struct
import threading
import time
import zlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

from repro_torch.core.rdma import RdmaFabric, SimulatedCrash

_U64 = struct.Struct("<Q")
_U64x2 = struct.Struct("<QQ")  # coalesced (tail_buf,tail_slot) / (head_buf,head_slot)

Part = Union[bytes, bytearray, memoryview]
PartsLike = Union[Part, Sequence[Part]]
_ENTRY_HDR = struct.Struct("<IIII")  # magic, payload_len, payload_crc, hdr_crc
ENTRY_MAGIC = 0x00EC_ECAF
ENTRY_HDR_BYTES = _ENTRY_HDR.size  # 16

# Header field offsets
OFF_LOCK = 0
OFF_TAIL_BUF = 8
OFF_TAIL_SLOT = 16
OFF_HEAD_BUF = 24
OFF_HEAD_SLOT = 32
OFF_SLOTS = 40
SLOT_BYTES = 8
BUSY_BIT = 1 << 63
SIZE_MASK = BUSY_BIT - 1


class Corrupt:
    """Sentinel returned by poll() for a discarded (checksum-failed) entry."""

    def __repr__(self) -> str:  # pragma: no cover
        return "<corrupt entry>"


CORRUPT = Corrupt()


def _advance(counter: int, size: int, region: int) -> tuple[int, int]:
    """Wrap rule: returns (start_pos, new_counter) for an entry of `size`."""
    pos = counter % region
    if pos + size <= region:
        return pos, counter + size
    skipped = region - pos  # unusable tail fragment
    return 0, counter + skipped + size


@dataclass
class RingBufferStats:
    produced: int = 0
    consumed: int = 0
    corrupt: int = 0
    aborts_full: int = 0
    aborts_cas: int = 0
    lock_takeovers: int = 0
    case7_recoveries: int = 0
    tail_fastforwards: int = 0


class DoubleRingBuffer:
    """Layout owner + consumer-side (co-located, wait-free) operations."""

    def __init__(
        self,
        fabric: RdmaFabric,
        region: str,
        *,
        n_slots: int = 256,
        buf_size: int = 1 << 20,
        create: bool = True,
        consumer_id: str = "consumer",
    ):
        self.fabric = fabric
        self.region = region
        self.n_slots = n_slots
        self.buf_size = buf_size
        self.slots_off = OFF_SLOTS
        self.buf_off = OFF_SLOTS + n_slots * SLOT_BYTES
        self.total_size = self.buf_off + buf_size
        self.consumer_id = consumer_id
        self.stats = RingBufferStats()
        # Optional repro_torch.analysis.ring_checker.RingProtocolChecker; when set,
        # every §6.1 atomic action is mirrored as a checker event.  None in
        # production — the emission guard is one attribute load.
        self.checker = None
        # Optional consumer-side doorbell hook (set_notify): producers call
        # ``notify()`` after every committed append so an idle consumer can
        # block on an Event instead of sleep-polling the ring.  Not a §6.1
        # protocol action (the checker never sees it) and NEVER invoked
        # while the ring lock is held — the blocking-under-lock lint
        # enforces that for callers holding Python locks too.
        self.notify_hook = None
        if create:
            fabric.register(region, self.total_size)

    def set_notify(self, hook) -> None:
        """Install the consumer wakeup hook (a zero-arg callable, e.g.
        ``threading.Event.set``).  Called by producers strictly after the
        ring lock is released; must be cheap and must not raise."""
        self.notify_hook = hook

    def notify(self) -> None:
        """Fire the consumer doorbell, if installed (producer side)."""
        h = self.notify_hook
        if h is not None:
            h()

    # ----------------------------------------------------------- low level
    def _slot_addr(self, slot_counter: int) -> int:
        return self.slots_off + (slot_counter % self.n_slots) * SLOT_BYTES

    def read_header(self, client: str) -> tuple[int, int, int, int]:
        raw = self.fabric.read(client, self.region, OFF_TAIL_BUF, 32)
        tb, ts, hb, hs = struct.unpack("<QQQQ", raw)
        return tb, ts, hb, hs

    # ------------------------------------------------------- consumer side
    def _write_head(self, hb: int, hs: int) -> None:
        """Head writeback coalesced into ONE 16-byte write (the two head
        counters are adjacent in the header)."""
        self.fabric.write(
            self.consumer_id, self.region, OFF_HEAD_BUF, _U64x2.pack(hb, hs)
        )

    def _consume_at(self, hb: int, hs: int):
        """Consume the entry at head position (hb, hs) if one is committed.

        Returns ``(item, new_hb, new_hs)``; ``item`` is None when the ring is
        empty at that position.  The busy bit is cleared here (only the
        consumer may do this, Theorem 2) but the head writeback is left to the
        caller so ``drain`` can batch it across entries.
        """
        f, me = self.fabric, self.consumer_id
        word = f.read_u64(me, self.region, self._slot_addr(hs))
        if not (word & BUSY_BIT):
            return None, hb, hs
        size = word & SIZE_MASK
        start, new_hb = _advance(hb, size, self.buf_size)
        raw = f.read(me, self.region, self.buf_off + start, size)
        # reset the busy bit — only the consumer may do this (Theorem 2)
        f.write_u64(me, self.region, self._slot_addr(hs), 0)
        # validate the data header (delayed-writer corruption detection)
        if size < ENTRY_HDR_BYTES:
            self.stats.corrupt += 1
            return CORRUPT, new_hb, hs + 1
        magic, plen, pcrc, hcrc = _ENTRY_HDR.unpack_from(raw, 0)
        if (
            magic != ENTRY_MAGIC
            or hcrc != zlib.crc32(raw[:12])
            or plen != size - ENTRY_HDR_BYTES
            or pcrc != zlib.crc32(raw[ENTRY_HDR_BYTES:])
        ):
            self.stats.corrupt += 1
            return CORRUPT, new_hb, hs + 1
        self.stats.consumed += 1
        return raw[ENTRY_HDR_BYTES:], new_hb, hs + 1

    def poll(self) -> Union[bytes, Corrupt, None]:
        """Wait-free consume of the next entry; None if nothing available.

        Header reads are coalesced into the single 32-byte ``read_header``
        (vs three 8-byte reads in the naive sequence) and the head advance
        into one 16-byte write.
        """
        _, _, hb, hs = self.read_header(self.consumer_id)
        item, new_hb, new_hs = self._consume_at(hb, hs)
        if item is None:
            return None
        self._write_head(new_hb, new_hs)
        if self.checker is not None:
            self.checker.event("head_wb", 0, hs=new_hs)
        return item

    def drain(self, limit: int = 1 << 30):
        """Consume everything currently available.

        The head writeback is batched: one 16-byte write for the whole run
        instead of two 8-byte writes per entry.  Producers observing the
        stale head in the meantime only ever see the ring as *fuller* than
        it is, which is conservative (they abort-full, never corrupt).
        """
        _, _, hb, hs = self.read_header(self.consumer_id)
        out: List[Union[bytes, Corrupt]] = []
        for _ in range(limit):
            item, hb2, hs2 = self._consume_at(hb, hs)
            if item is None:
                break
            out.append(item)
            hb, hs = hb2, hs2
        if out:
            self._write_head(hb, hs)
            if self.checker is not None:
                self.checker.event("head_wb", 0, hs=hs)
        return out


def _as_parts(payload: PartsLike) -> List[Part]:
    """Normalize a payload to a flat list of buffer parts (no copies)."""
    if isinstance(payload, (bytes, bytearray, memoryview)):
        return [payload]
    return list(payload)


def _entry_parts(payload: PartsLike) -> List[Part]:
    """Scatter-gather entry framing: the 16B data header followed by the
    payload parts as-is — the parts are never concatenated in Python; they
    are gathered by a single ``writev`` on the wire."""
    parts = _as_parts(payload)
    plen = 0
    pcrc = 0
    for p in parts:
        plen += len(p)
        pcrc = zlib.crc32(p, pcrc)
    hdr12 = struct.pack("<III", ENTRY_MAGIC, plen, pcrc)
    return [hdr12 + struct.pack("<I", zlib.crc32(hdr12))] + parts


def _pack_entry(payload: bytes) -> bytes:
    return b"".join(_entry_parts(payload))


class AppendOp:
    """Producer append as the paper's explicit atomic-action sequence.

    Steps (returned by .step() in order):
      'lock' -> 'gh' -> 'wb' -> 'wl' -> 'uh' -> 'unlock' -> 'done'
    Terminal early exits: 'abort_full' (insufficient space, lock released),
    'abort_cas' (delayed producer lost the size-slot CAS, Cases 2/3/6).

    The payload may be a single buffer or a sequence of buffer parts
    (scatter-gather); WB issues one gathered write either way.
    """

    def __init__(self, producer: "RingProducer", payload: PartsLike):
        self.p = producer
        self.rb = producer.rb
        self.parts = _entry_parts(payload)
        self.size = sum(len(p) for p in self.parts)
        self.token = producer._new_token()
        self.state = "lock"
        # filled during gh:
        self.tail_buf = self.tail_slot = 0
        self.write_pos = self.new_tail = 0

    @property
    def entry(self) -> bytes:
        return b"".join(self.parts)

    # one paper-step per call; returns the state just executed
    def step(self) -> str:
        m = getattr(self, "_s_" + self.state)
        return m()

    def run(self) -> str:
        while self.state not in ("done", "abort_full", "abort_cas"):
            self.step()
        return self.state

    # ------------------------------------------------------------- states
    def _s_lock(self) -> str:
        takeover, waited = self.p._acquire(self.token)
        ck = self.rb.checker
        if ck is not None:
            ck.event("lock", self.token, takeover=takeover, waited=waited,
                     timeout=self.p.lock_timeout_s, op="single")
        self.state = "gh"
        return "lock"

    def _s_gh(self) -> str:
        """Read header; Case-7 recovery; space check."""
        rb, f, me = self.rb, self.rb.fabric, self.p.client
        ck = rb.checker
        while True:
            tb, ts, hb, hs = rb.read_header(me)
            if ck is not None:
                ck.event("gh", self.token, tb=tb, ts=ts, hb=hb, hs=hs)
            if hs > ts:
                # Stale tail: a previous lock holder committed entries (WL)
                # that the consumer already drained via their busy bits, but
                # its doorbell (UH) never landed — takeover mid-batch — or
                # will land late and rewind the header.  Appending below the
                # consumer head would strand the entry beyond consumption
                # forever; fast-forward to the head, which is always a safe
                # lower bound for the true tail (everything before it was
                # committed AND consumed).
                if ck is not None:
                    ck.event("fastforward", self.token, ts=ts, hs=hs)
                tb, ts = hb, hs
                rb.stats.tail_fastforwards += 1
            if ts - hs >= rb.n_slots:
                self.p._release(self.token)
                rb.stats.aborts_full += 1
                if ck is not None:
                    ck.event("abort_full", self.token)
                    ck.event("unlock", self.token)
                self.state = "abort_full"
                return "gh"
            word = f.read_u64(me, rb.region, rb._slot_addr(ts))
            if word & BUSY_BIT:
                # Case 7: a previous producer wrote data + size then died
                # before UH.  Advance the header past its entry first.
                _, tb2 = _advance(tb, word & SIZE_MASK, rb.buf_size)
                f.write(me, rb.region, OFF_TAIL_BUF, _U64x2.pack(tb2, ts + 1))
                rb.stats.case7_recoveries += 1
                if ck is not None:
                    ck.event("case7", self.token, ts=ts)
                continue
            self.write_pos, self.new_tail = _advance(tb, self.size, rb.buf_size)
            if self.new_tail - hb > rb.buf_size:
                self.p._release(self.token)
                rb.stats.aborts_full += 1
                if ck is not None:
                    ck.event("abort_full", self.token)
                    ck.event("unlock", self.token)
                self.state = "abort_full"
                return "gh"
            self.tail_buf, self.tail_slot = tb, ts
            self.state = "wb"
            return "gh"

    def _s_wb(self) -> str:
        rb = self.rb
        rb.fabric.writev(
            self.p.client, rb.region, rb.buf_off + self.write_pos, self.parts
        )
        if rb.checker is not None:
            rb.checker.event("wb", self.token)
        self.state = "wl"
        return "wb"

    def _s_wl(self) -> str:
        """Claim the size slot with CAS(0 -> busy|size)."""
        rb = self.rb
        word = BUSY_BIT | self.size
        old = rb.fabric.compare_and_swap(
            self.p.client, rb.region, rb._slot_addr(self.tail_slot), 0, word
        )
        if old != 0:
            # A delayed producer: someone else finalized this slot first
            # (Cases 2, 3, 6).  Our buffer write may have corrupted their
            # payload — the consumer's checksum will discard it.
            rb.stats.aborts_cas += 1
            if rb.checker is not None:
                rb.checker.event("wl", self.token, won=False)
            self.state = "abort_cas"
            return "wl"
        if rb.checker is not None:
            rb.checker.event("wl", self.token, won=True)
        self.state = "uh"
        return "wl"

    def _s_uh(self) -> str:
        rb, f, me = self.rb, self.rb.fabric, self.p.client
        # tail_buf/tail_slot are adjacent: one 16B write, not two 8B writes
        f.write(me, rb.region, OFF_TAIL_BUF,
                _U64x2.pack(self.new_tail, self.tail_slot + 1))
        if rb.checker is not None:
            rb.checker.event("uh", self.token, ts=self.tail_slot + 1)
        self.state = "unlock"
        return "uh"

    def _s_unlock(self) -> str:
        self.p._release(self.token)
        self.rb.stats.produced += 1
        if self.rb.checker is not None:
            self.rb.checker.event("unlock", self.token)
        self.state = "done"
        self.rb.notify()  # doorbell: strictly after the ring lock release
        return "unlock"


class RingProducer:
    """Producer endpoint (one per sending instance)."""

    def __init__(
        self,
        rb: DoubleRingBuffer,
        producer_id: int,
        *,
        lock_timeout_s: float = 0.1,
        client: Optional[str] = None,
    ):
        # lock_timeout_s guards against CRASHED lock holders (§6.1 TL).  It
        # must comfortably exceed how long a *live* producer can stall while
        # holding the lock: a doorbell-batched append_many writes + CRCs a
        # whole batch under the lock, and on a loaded box (GIL, XLA worker
        # threads) that routinely exceeds the seed's 2 ms — takeover of a
        # live producer triggers the Case-2 same-size clobber, which passes
        # the checksum and silently replaces one message with a duplicate
        # of another.  100 ms keeps crash recovery prompt while making
        # live-producer takeover practically impossible in-process.
        self.rb = rb
        self.producer_id = producer_id
        self.lock_timeout_s = lock_timeout_s
        self.client = client or f"producer-{producer_id}"
        self._nonce = 0
        # Channel.send_parts/send_many call append from arbitrary threads
        # without any Python lock (holding one across a ring append would
        # stall every other sender — see the blocking-under-lock lint); the
        # nonce is the only producer-local mutable word, so it takes its own
        # leaf mutex.
        self._nonce_lock = threading.Lock()

    def _new_token(self) -> int:
        # `or 1` binds to the wrapped nonce, not the whole token: after the
        # 24-bit nonce wraps to 0 the token must still be non-zero (and carry
        # a non-zero nonce) for EVERY producer id, including id 0 — a zero
        # token would alias the unlocked state.
        with self._nonce_lock:
            self._nonce = (self._nonce + 1) & 0xFFFFFF or 1
            return (self.producer_id << 24) | self._nonce

    # ----------------------------------------------------------- lock mgmt
    def _acquire(self, token: int) -> tuple[bool, float]:
        """Returns (was_takeover, seconds spent watching the final holder)."""
        rb, f = self.rb, self.rb.fabric
        t0 = time.monotonic()
        seen: Optional[int] = None
        seen_at = t0
        while True:
            old = f.compare_and_swap(self.client, rb.region, OFF_LOCK, 0, token)
            if old == 0:
                return False, time.monotonic() - t0
            now = time.monotonic()
            if old != seen:
                seen, seen_at = old, now
            elif now - seen_at >= self.lock_timeout_s:
                # TL: the holder looks dead — take the lock over (§6.1).
                got = f.compare_and_swap(self.client, rb.region, OFF_LOCK, old, token)
                if got == old:
                    rb.stats.lock_takeovers += 1
                    return True, now - seen_at
                seen = None
            time.sleep(0)  # yield

    def _release(self, token: int) -> None:
        # CAS so a takeover victim cannot free a lock it no longer owns.
        self.rb.fabric.compare_and_swap(
            self.client, self.rb.region, OFF_LOCK, token, 0
        )

    # --------------------------------------------------------------- append
    def start_append(self, payload: PartsLike) -> AppendOp:
        return AppendOp(self, payload)

    def append(self, payload: PartsLike) -> bool:
        """Returns True on success, False if the ring was full or CAS lost.

        ``payload`` may be a single buffer or a sequence of buffer parts
        (scatter-gather) — parts are gathered by one ``writev`` on the wire.
        """
        try:
            return self.start_append(payload).run() == "done"
        except SimulatedCrash:
            raise

    def append_many(self, payloads: Sequence[PartsLike]) -> int:
        """Doorbell-batched append: ONE lock acquire and ONE tail-header
        update amortized across up to ``len(payloads)`` entries.

        Per entry the protocol still performs the individually-required
        actions — Case-7 busy-slot recovery, the WB gathered write and the
        WL size-slot CAS — so the abort semantics of Cases 2/3/6 are
        preserved exactly: a delayed batch producer that loses a slot CAS to
        a lock-takeover stops immediately (its committed prefix has already
        been recovered past by the new lock holder; writing our stale tail
        would rewind the header).

        Returns the number of entries appended (a prefix of ``payloads``).
        """
        rb, f, me = self.rb, self.rb.fabric, self.client
        entries = []
        for pl in payloads:
            parts = _entry_parts(pl)
            entries.append((parts, sum(len(p) for p in parts)))
        if not entries:
            return 0
        token = self._new_token()
        takeover, waited = self._acquire(token)
        ck = rb.checker
        if ck is not None:
            ck.event("lock", token, takeover=takeover, waited=waited,
                     timeout=self.lock_timeout_s, op="batch")
        # Stale-tail fast-forward (hs > ts) is handled at the top of each
        # entry's scan loop below — see AppendOp._s_gh for the full story.
        tb, ts, hb, hs = rb.read_header(me)
        if ck is not None:
            ck.event("gh", token, tb=tb, ts=ts, hb=hb, hs=hs)
        appended = 0
        full = False
        for parts, size in entries:
            # Case-7 scan at the current tail slot (same recovery as _s_gh).
            refreshed = False
            while True:
                if hs > ts:
                    # consumer drained past our (stale) tail view — e.g. we
                    # were taken over mid-batch and the taker's entries were
                    # already consumed; never append behind the head.
                    if ck is not None:
                        ck.event("fastforward", token, ts=ts, hs=hs)
                    tb, ts = hb, hs
                    rb.stats.tail_fastforwards += 1
                if ts - hs >= rb.n_slots:
                    if refreshed:
                        full = True
                        break
                    _, _, hb, hs = rb.read_header(me)  # head may have moved
                    if ck is not None:
                        ck.event("gh", token, hs=hs)
                    refreshed = True
                    continue
                word = f.read_u64(me, rb.region, rb._slot_addr(ts))
                if not (word & BUSY_BIT):
                    break
                _, tb = _advance(tb, word & SIZE_MASK, rb.buf_size)
                ts += 1
                f.write(me, rb.region, OFF_TAIL_BUF, _U64x2.pack(tb, ts))
                rb.stats.case7_recoveries += 1
                if ck is not None:
                    ck.event("case7", token, ts=ts)
            if full:
                break
            write_pos, new_tail = _advance(tb, size, rb.buf_size)
            if new_tail - hb > rb.buf_size:
                if not refreshed:
                    _, _, hb, hs = rb.read_header(me)
                    if ck is not None:
                        ck.event("gh", token, hs=hs)
                    if hs > ts:
                        if ck is not None:
                            ck.event("fastforward", token, ts=ts, hs=hs)
                        tb, ts = hb, hs
                        rb.stats.tail_fastforwards += 1
                        write_pos, new_tail = _advance(tb, size, rb.buf_size)
                if new_tail - hb > rb.buf_size:
                    full = True
                    break
            f.writev(me, rb.region, rb.buf_off + write_pos, parts)
            if ck is not None:
                ck.event("wb", token)
            old = f.compare_and_swap(
                me, rb.region, rb._slot_addr(ts), 0, BUSY_BIT | size
            )
            if old != 0:
                # Delayed batch: a takeover producer finalized this slot
                # first (Cases 2/3/6) and already advanced the header past
                # our committed prefix via Case-7 recovery.  Abort the rest;
                # neither the tail header nor the lock is ours anymore.
                rb.stats.aborts_cas += 1
                rb.stats.produced += appended
                if ck is not None:
                    ck.event("wl", token, won=False)
                if appended:
                    # the committed prefix is consumable via its busy bits
                    # (the taker's Case-7 recovery advanced the header past
                    # it) — wake the consumer for it; the lock is the
                    # taker's, not ours, so this is still post-unlock.
                    rb.notify()
                return appended
            if ck is not None:
                ck.event("wl", token, won=True)
            tb, ts = new_tail, ts + 1
            appended += 1
        if appended:
            # the single batched UH ("doorbell"): one 16B tail-header write
            f.write(me, rb.region, OFF_TAIL_BUF, _U64x2.pack(tb, ts))
            rb.stats.produced += appended
            if ck is not None:
                ck.event("uh", token, ts=ts)
        if full:
            rb.stats.aborts_full += 1
            if ck is not None:
                ck.event("abort_full", token)
        self._release(token)
        if ck is not None:
            ck.event("unlock", token)
        if appended:
            rb.notify()  # one doorbell for the whole batch, post-unlock
        return appended

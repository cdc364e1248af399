"""Ring-protocol state-machine checker (§6.1).

A :class:`RingProtocolChecker` attached to a ``DoubleRingBuffer``
(``rb.checker = RingProtocolChecker()``) receives one event per atomic
protocol action a producer performs — Lock, GH (get head), WB (write
body), WL (write length/commit), UH (update head), Unlock — plus the
recovery actions (takeover, Case-7 busy-slot recovery, stale-tail
fast-forward, abort-full) and validates the legal transition structure:

* WB only after GH within the same locked append, and not after UH;
* every WL must follow a WB (the commit word is written last);
* UH only after at least one *won* WL, and never twice per append;
* losing the WL CAS ends the append with NO unlock (the lock was
  taken over — it is no longer ours to release);
* takeover only after waiting at least the configured lock timeout;
* fast-forward only when the producer-observed head has genuinely
  passed the stale tail snapshot (hs > ts);
* the consumer's head write-backs never move the head backwards;
* a takeover supersedes the abandoned holder's append — its delayed
  doorbell may rewind the tail (the hazard fast-forward repairs) and is
  exempt from the monotonic-published-tail rule.

Events carry the raw protocol operands (head/tail snapshots, wait
times) so violations localise the exact illegal interleaving.  The
checker never raises from the data path; violations accumulate and are
asserted at test end (see tests/conftest.py and tests/test_ring_buffer).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

# epsilon for takeover-timing: perf_counter skew across threads
_T_EPS = 1e-4


@dataclasses.dataclass
class RingViolation:
    event: str
    msg: str

    def __str__(self) -> str:
        return f"[ring-protocol] {self.event}: {self.msg}"


class _OpState:
    __slots__ = ("kind", "gh_seen", "wb_pending", "wb_count", "wl_won",
                 "uh_done", "done", "superseded")

    def __init__(self, kind: str):
        self.kind = kind          # "single" | "batch"
        self.gh_seen = False
        self.wb_pending = 0       # WBs awaiting their WL commit
        self.wb_count = 0
        self.wl_won = 0
        self.uh_done = False
        self.done = False
        self.superseded = False   # ring lock was taken over from this op


class RingProtocolChecker:
    """Validates the per-producer event stream.  Thread-safe: producers
    emit concurrently; state is keyed by producer token."""

    def __init__(self, name: str = "ring"):
        self.name = name
        self._mu = threading.Lock()
        self._ops: Dict[int, _OpState] = {}
        self.violations: List[RingViolation] = []
        self._last_cons_hs: Optional[int] = None   # consumer head slot ctr
        self._last_pub_ts: Optional[int] = None    # published tail slot ctr
        self.events_seen = 0
        self.counts: Dict[str, int] = {}

    # ------------------------------------------------------------- helpers
    def _bad(self, event: str, msg: str) -> None:
        self.violations.append(RingViolation(event, msg))

    def _op(self, token: int, event: str) -> Optional[_OpState]:
        op = self._ops.get(token)
        if op is None:
            self._bad(event, f"token {token:#x}: {event} with no open "
                             "locked append (no Lock event seen)")
        return op

    # --------------------------------------------------------------- events
    def event(self, kind: str, token: int, **info) -> None:
        """kind in {lock, gh, fastforward, case7, wb, wl, uh, abort_full,
        unlock, head_wb}.  See DoubleRingBuffer/_RingProducer call sites."""
        with self._mu:
            self.events_seen += 1
            self.counts[kind] = self.counts.get(kind, 0) + 1
            getattr(self, f"_on_{kind}")(token, info)

    def _on_lock(self, token: int, info: dict) -> None:
        if info.get("takeover"):
            waited = float(info.get("waited", 0.0))
            timeout = float(info.get("timeout", 0.0))
            if waited + _T_EPS < timeout:
                self._bad("lock",
                          f"token {token:#x}: takeover after only "
                          f"{waited * 1e3:.2f} ms < timeout "
                          f"{timeout * 1e3:.2f} ms")
            # The abandoned holder's append is no longer protocol-ordered:
            # its delayed doorbell may legally rewind the published tail
            # (the stale-tail hazard the fast-forward exists for).
            for other in self._ops.values():
                if not other.done:
                    other.superseded = True
        if token in self._ops and not self._ops[token].done:
            self._bad("lock", f"token {token:#x}: Lock while a previous "
                              "append with the same token is still open")
        self._ops[token] = _OpState(str(info.get("op", "single")))

    def _on_gh(self, token: int, info: dict) -> None:
        op = self._op(token, "gh")
        if op is None:
            return
        op.gh_seen = True
        hs = info.get("hs")
        if hs is not None:
            # Fold the observation into the watermark but do NOT flag a lower
            # value: a producer's read and its event emission are not atomic,
            # so under concurrency a stale-looking gh is just a late emission.
            # (Folding is safe: reading hs=v happens-after the consumer wrote
            # v, and the consumer emits head_wb in write order, so any later
            # head_wb carries >= v.)  Monotonicity is enforced on the
            # single-threaded consumer stream in _on_head_wb.
            self._last_cons_hs = max(self._last_cons_hs or 0, hs)

    def _on_fastforward(self, token: int, info: dict) -> None:
        op = self._op(token, "fastforward")
        if op is None:
            return
        ts, hs = info.get("ts"), info.get("hs")
        if ts is not None and hs is not None and not hs > ts:
            self._bad("fastforward",
                      f"token {token:#x}: fast-forward with head snapshot "
                      f"{hs} <= tail snapshot {ts} (tail was not stale)")

    def _on_case7(self, token: int, info: dict) -> None:
        op = self._op(token, "case7")
        if op is not None and not op.gh_seen:
            self._bad("case7", f"token {token:#x}: Case-7 recovery before GH")

    def _on_wb(self, token: int, info: dict) -> None:
        op = self._op(token, "wb")
        if op is None:
            return
        if not op.gh_seen:
            self._bad("wb", f"token {token:#x}: WB before GH")
        if op.uh_done:
            self._bad("wb", f"token {token:#x}: WB after UH (head already "
                            "published past this slot)")
        op.wb_pending += 1
        op.wb_count += 1

    def _on_wl(self, token: int, info: dict) -> None:
        op = self._op(token, "wl")
        if op is None:
            return
        if op.wb_pending <= 0:
            self._bad("wl", f"token {token:#x}: WL with no preceding WB")
        else:
            op.wb_pending -= 1
        if info.get("won", True):
            op.wl_won += 1
        else:
            # CAS lost: the ring lock was taken over; the append is over
            # and the producer must NOT release the lock.
            op.done = True

    def _on_uh(self, token: int, info: dict) -> None:
        op = self._op(token, "uh")
        if op is None:
            return
        if op.uh_done:
            self._bad("uh", f"token {token:#x}: double UH in one append")
        if op.wl_won < 1:
            self._bad("uh", f"token {token:#x}: UH with no won WL commit")
        op.uh_done = True
        ts = info.get("ts")
        if ts is not None and not op.superseded:
            # A superseded producer's delayed doorbell is the known rewind
            # hazard (handled by the next producer's fast-forward); only
            # current lock holders advance the monotonic watermark.
            if self._last_pub_ts is not None and ts < self._last_pub_ts:
                self._bad("uh", f"token {token:#x}: UH rewound the published "
                                f"tail ({self._last_pub_ts} -> {ts})")
            self._last_pub_ts = max(self._last_pub_ts or 0, ts)

    def _on_abort_full(self, token: int, info: dict) -> None:
        self._op(token, "abort_full")

    def _on_unlock(self, token: int, info: dict) -> None:
        op = self._op(token, "unlock")
        if op is None:
            return
        if op.done:
            self._bad("unlock", f"token {token:#x}: Unlock after a lost WL "
                                "CAS — the lock belongs to the taker-over")
        op.done = True
        del self._ops[token]

    def _on_head_wb(self, token: int, info: dict) -> None:
        # consumer-side write-back of the advanced head; token is 0.
        # (The head may legally pass the PUBLISHED tail: Case-7 entries have
        # their busy bit set before any doorbell lands — that is exactly the
        # hs > ts condition the producer fast-forward exists for.)
        hs = info.get("hs")
        if hs is not None:
            if self._last_cons_hs is not None and hs < self._last_cons_hs:
                self._bad("head_wb", "consumer head write-back moved "
                          f"backwards ({self._last_cons_hs} -> {hs})")
            self._last_cons_hs = max(self._last_cons_hs or 0, hs)

    # ------------------------------------------------------------- queries
    def open_ops(self) -> int:
        with self._mu:
            return sum(1 for op in self._ops.values() if not op.done)

    def assert_clean(self) -> None:
        with self._mu:
            if self.violations:
                raise AssertionError(
                    f"{self.name}: {len(self.violations)} ring-protocol "
                    "violation(s):\n" +
                    "\n".join(str(v) for v in self.violations))

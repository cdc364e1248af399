"""Request monitor with fast-reject (§3.2, §5).

The proxy admits requests only while the arrival rate stays below the
Theorem-1 admissible rate K/T_X (computed from live instance info supplied
by the NodeManager).  Anything beyond is rejected immediately so the client
can retry against another Workflow Set — this is what gives OnePiece its
cross-set load balancing and bounded latency.

In-flight tracking (``max_in_flight``) is leak-proof: the data plane may
drop a request anywhere downstream (§9 never retransmits), in which case
``Proxy.complete()`` is never called for it — each in-flight token therefore
carries its admission timestamp and expires after ``in_flight_ttl_s``, so a
burst of drops can never wedge admission permanently.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

from repro_torch.analysis.runtime import make_lock


@dataclass
class MonitorStats:
    admitted: int = 0
    rejected: int = 0
    expired: int = 0  # in-flight tokens reclaimed by TTL (downstream drops)

    @property
    def reject_rate(self) -> float:
        total = self.admitted + self.rejected
        return self.rejected / total if total else 0.0


class RequestMonitor:
    """Sliding-window admission control at the proxy."""

    def __init__(
        self,
        t_entrance_s: float,
        k_entrance: int,
        *,
        window_s: float = 1.0,
        max_in_flight: int = 0,
        in_flight_ttl_s: float = 30.0,
        nm_managed: bool = False,
        clock=time.monotonic,
    ):
        self._lock = make_lock("RequestMonitor._lock")
        self.window_s = window_s
        self.clock = clock
        self.stats = MonitorStats()
        self._arrivals: deque = deque()  # guarded_by: _lock
        self._in_flight: deque = deque()  # admission stamps, oldest first; guarded_by: _lock
        self.max_in_flight = max_in_flight  # 0 = unbounded
        self.in_flight_ttl_s = in_flight_ttl_s
        # NM-managed monitors get live (T_X, K) pushes from the control
        # loop; unmanaged ones keep whatever capacity they were built with.
        self.nm_managed = nm_managed
        self.update_capacity(t_entrance_s, k_entrance)

    # NM pushes fresh instance info here (Section 5: "continuously calculates K")
    def update_capacity(self, t_entrance_s: float, k_entrance: int) -> None:
        with self._lock:
            self.t_entrance_s = t_entrance_s
            self.k_entrance = k_entrance

    @property
    def admissible_rate(self) -> float:
        return self.k_entrance / self.t_entrance_s

    @property
    def in_flight(self) -> int:
        with self._lock:
            return len(self._in_flight)

    def _expire_in_flight_locked(self, now: float) -> None:
        while self._in_flight and now - self._in_flight[0] > self.in_flight_ttl_s:
            self._in_flight.popleft()
            self.stats.expired += 1

    def try_admit(self) -> bool:
        now = self.clock()
        with self._lock:
            while self._arrivals and now - self._arrivals[0] > self.window_s:
                self._arrivals.popleft()
            self._expire_in_flight_locked(now)
            rate_ok = len(self._arrivals) < self.admissible_rate * self.window_s
            flight_ok = (not self.max_in_flight
                         or len(self._in_flight) < self.max_in_flight)
            if rate_ok and flight_ok:
                self._arrivals.append(now)
                self._in_flight.append(now)
                self.stats.admitted += 1
                return True
            self.stats.rejected += 1
            return False

    def complete(self) -> None:
        """One admitted request reached a terminal state (result stored, or
        known-dropped at the entrance ring) — release its in-flight token."""
        with self._lock:
            if self._in_flight:
                self._in_flight.popleft()

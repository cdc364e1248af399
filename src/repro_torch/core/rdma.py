"""Simulated one-sided RDMA fabric.

The paper's transport relies on exactly four one-sided verbs — remote
``read``, ``write``, ``compare_and_swap`` and ``fetch_add`` on *registered
memory regions* — none of which involve the remote CPU (§2.1).  This module
provides those verbs over process-local numpy regions so every algorithm
above it (double-ring buffer, messaging, liveness recovery) is the paper's
algorithm verbatim; on a real cluster the carrier would be IB verbs / EFA.

Fidelity notes:
  * Atomics (CAS / fetch-add) are serialized per-region through a lock —
    RDMA NICs guarantee atomicity of 8-byte atomics but NOT atomicity of
    plain reads/writes w.r.t. them; plain read/write here copies without
    taking the atomic lock, so torn reads are possible exactly like on
    real hardware.
  * A latency/bandwidth cost model is *recorded* (not slept) per verb so
    benchmarks can report modeled wire time; ``sleep=True`` enables real
    delays for contention experiments.
  * Fault injection: per-client verb hooks can drop, delay or kill a
    client mid-sequence — used by the liveness tests (Cases 1-8, §6.1).
"""
from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np

from repro_torch.analysis.runtime import make_lock

Buf = Union[bytes, bytearray, memoryview]

_U64 = struct.Struct("<Q")


class SimulatedCrash(RuntimeError):
    """Raised by fault hooks to kill a client mid-operation-sequence."""


@dataclass
class CostModel:
    """One-sided RDMA verb cost model (defaults ~ published IB verbs numbers)."""

    base_latency_s: float = 2.0e-6       # one-sided verb latency
    bandwidth_Bps: float = 25e9          # 200 Gb/s HCA
    atomic_latency_s: float = 2.5e-6

    def op_time(self, verb: str, nbytes: int) -> float:
        if verb in ("cas", "faa"):
            return self.atomic_latency_s
        return self.base_latency_s + nbytes / self.bandwidth_Bps


@dataclass
class TcpCostModel:
    """Kernel-socket baseline: syscall + multiple copies + interrupt (§1, §6)."""

    base_latency_s: float = 30.0e-6
    bandwidth_Bps: float = 5e9           # effective after copies
    per_copy_overhead: int = 2           # app->kernel->NIC copies

    def op_time(self, verb: str, nbytes: int) -> float:
        eff = self.bandwidth_Bps / self.per_copy_overhead
        return self.base_latency_s + nbytes / eff


@dataclass
class FabricStats:
    ops: Dict[str, int] = field(default_factory=dict)
    bytes: Dict[str, int] = field(default_factory=dict)
    modeled_time_s: float = 0.0
    # scatter-gather accounting: writev is recorded as a single "write" op
    # (it is one one-sided WRITE with a sender-side gather list); these two
    # fields let benchmarks report how many Python-level concats it elided.
    writev_ops: int = 0
    writev_parts: int = 0

    def record(self, verb: str, nbytes: int, t: float) -> None:
        self.ops[verb] = self.ops.get(verb, 0) + 1
        self.bytes[verb] = self.bytes.get(verb, 0) + nbytes
        self.modeled_time_s += t

    @property
    def total_ops(self) -> int:
        return sum(self.ops.values())

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes.values())


class MemoryRegion:
    """A registered, remotely-accessible memory region."""

    def __init__(self, name: str, size: int):
        self.name = name
        # plain read/write deliberately bypass atomic_lock (torn reads are
        # possible exactly like on real hardware) — so buf is NOT guarded
        self.buf = np.zeros(size, dtype=np.uint8)
        self.atomic_lock = make_lock("MemoryRegion.atomic_lock")

    def __len__(self) -> int:
        return len(self.buf)


# A fault hook receives (client_id, verb, region, offset, nbytes) and may
# raise SimulatedCrash, sleep, or return False to drop the op silently.
FaultHook = Callable[[str, str, str, int, int], Optional[bool]]


class RdmaFabric:
    """Registry of memory regions + the four one-sided verbs."""

    def __init__(self, cost: Optional[CostModel] = None, sleep: bool = False):
        self.regions: Dict[str, MemoryRegion] = {}
        self.cost = cost or CostModel()
        self.sleep = sleep
        self.stats = FabricStats()  # guarded_by: _stats_lock
        self._stats_lock = make_lock("RdmaFabric._stats_lock")
        self.fault_hook: Optional[FaultHook] = None

    # ------------------------------------------------------------- registry
    def register(self, name: str, size: int) -> MemoryRegion:
        if name in self.regions:
            raise ValueError(f"region {name!r} already registered")
        mr = MemoryRegion(name, size)
        self.regions[name] = mr
        return mr

    def _mr(self, region: str) -> MemoryRegion:
        return self.regions[region]

    def _account(self, client: str, verb: str, region: str, offset: int, n: int) -> bool:
        if self.fault_hook is not None:
            ok = self.fault_hook(client, verb, region, offset, n)
            if ok is False:
                return False
        t = self.cost.op_time(verb, n)
        with self._stats_lock:
            self.stats.record(verb, n, t)
        if self.sleep and t > 0:
            time.sleep(t)
        return True

    # ----------------------------------------------------------- data verbs
    def write(self, client: str, region: str, offset: int, data: bytes) -> None:
        """One-sided RDMA WRITE — no remote CPU involvement."""
        if not self._account(client, "write", region, offset, len(data)):
            return  # dropped on the wire
        mr = self._mr(region)
        mr.buf[offset : offset + len(data)] = np.frombuffer(data, dtype=np.uint8)

    def writev(
        self, client: str, region: str, offset: int, parts: Sequence[Buf]
    ) -> None:
        """One-sided RDMA WRITE with a sender-side gather list (scatter-gather
        framing): the NIC pulls each local buffer directly — no intermediate
        concatenated blob.  Accounted as ONE ``write`` op so fault hooks and
        op-count stats see exactly what the wire sees."""
        total = sum(len(p) for p in parts)
        if not self._account(client, "write", region, offset, total):
            return  # dropped on the wire
        with self._stats_lock:
            self.stats.writev_ops += 1
            self.stats.writev_parts += len(parts)
        mr = self._mr(region)
        pos = offset
        for p in parts:
            n = len(p)
            if n:
                mr.buf[pos : pos + n] = np.frombuffer(p, dtype=np.uint8)
            pos += n

    def read(self, client: str, region: str, offset: int, nbytes: int) -> bytes:
        """One-sided RDMA READ."""
        self._account(client, "read", region, offset, nbytes)
        mr = self._mr(region)
        return mr.buf[offset : offset + nbytes].tobytes()

    # --------------------------------------------------------- atomic verbs
    def compare_and_swap(
        self, client: str, region: str, offset: int, expected: int, new: int
    ) -> int:
        """8-byte CAS; returns the value observed before the swap."""
        self._account(client, "cas", region, offset, 8)
        mr = self._mr(region)
        with mr.atomic_lock:
            cur = _U64.unpack_from(mr.buf, offset)[0]
            if cur == expected:
                _U64.pack_into(mr.buf, offset, new)
            return cur

    def fetch_add(self, client: str, region: str, offset: int, delta: int) -> int:
        self._account(client, "faa", region, offset, 8)
        mr = self._mr(region)
        with mr.atomic_lock:
            cur = _U64.unpack_from(mr.buf, offset)[0]
            _U64.pack_into(mr.buf, offset, (cur + delta) % (1 << 64))
            return cur

    # ------------------------------------------------------------- helpers
    def read_u64(self, client: str, region: str, offset: int) -> int:
        return _U64.unpack(self.read(client, region, offset, 8))[0]

    def write_u64(self, client: str, region: str, offset: int, value: int) -> None:
        self.write(client, region, offset, _U64.pack(value))

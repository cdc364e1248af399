"""OnePiece core: the paper's primary contributions.

  * rdma            — simulated one-sided RDMA fabric (read/write/CAS/FAA)
  * ring_buffer     — deadlock-free multi-producer double-ring buffer (§6.1)
  * messaging       — workflow message codec, arbitrary dynamic payloads (§4.1)
  * transport       — unified Channel/Router data plane over the rings
  * batching        — cross-request microbatching (stack/unstack, buckets)
  * pipeline_planner— Theorem-1 rate matching (§5)
  * request_monitor — proxy fast-reject admission control (§3.2, §5)
  * profiling       — per-request latency spans (docs/perf.md)
"""
from repro_torch.core.batching import (
    Coalescer,
    PerRequest,
    bucket_key,
    stack_payloads,
    unstack_payload,
)
from repro_torch.core.rdma import CostModel, FabricStats, MemoryRegion, RdmaFabric, SimulatedCrash, TcpCostModel
from repro_torch.core.ring_buffer import CORRUPT, AppendOp, Corrupt, DoubleRingBuffer, RingProducer
from repro_torch.core.messaging import HEADER_BYTES, KVPages, WorkflowMessage
from repro_torch.core.transport import Channel, ChannelStats, Router
from repro_torch.core.pipeline_planner import (
    critical_path,
    offered_rate,
    plan_chain,
    plan_dag,
    required_instances,
    simulate_dag,
    simulate_pipeline,
    steady_state_latency,
    topo_sort,
)
from repro_torch.core.profiling import EVENTS, PHASES, LatencyProfiler, profiler
from repro_torch.core.request_monitor import RequestMonitor

__all__ = [
    "EVENTS",
    "PHASES",
    "LatencyProfiler",
    "profiler",
    "AppendOp",
    "CORRUPT",
    "Channel",
    "ChannelStats",
    "Coalescer",
    "Corrupt",
    "CostModel",
    "Router",
    "DoubleRingBuffer",
    "FabricStats",
    "HEADER_BYTES",
    "MemoryRegion",
    "PerRequest",
    "RdmaFabric",
    "RequestMonitor",
    "RingProducer",
    "SimulatedCrash",
    "TcpCostModel",
    "KVPages",
    "WorkflowMessage",
    "bucket_key",
    "critical_path",
    "offered_rate",
    "stack_payloads",
    "unstack_payload",
    "plan_chain",
    "plan_dag",
    "required_instances",
    "simulate_dag",
    "simulate_pipeline",
    "steady_state_latency",
    "topo_sort",
]

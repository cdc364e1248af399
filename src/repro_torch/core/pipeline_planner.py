"""Pipelining (§5): Theorem-1 rate matching and a discrete-event validator.

Theorem 1: for stages X (K parallel requests, time T_X) and Y (time T_Y),
assigning M = ceil(K * T_Y / T_X) parallel requests to Y makes the output
rate of Y equal the input rate K/T_X, with steady-state per-request latency
T_X + T_Y + network.

The planner generalizes this to an N-stage chain: with the entrance stage
processing K requests in parallel, stage i needs M_i = ceil(K * T_i / T_0)
instances.  ``simulate_pipeline`` is an exact discrete-event simulation used
by the tests and by ``benchmarks/bench_pipelining.py`` to validate the
theorem and to measure what happens under mis-provisioning.

DAG workflows (docs/workflows.md) extend the theorem per *path*: every
request visits every stage exactly once (fan-out duplicates the message,
fan-in joins merge it back), so each stage still sees the full admission
rate K/T_0 where T_0 is the slowest entrance stage.  ``plan_dag`` applies
the same M = ceil(K * T_i / T_0) per stage; the steady-state latency drops
from the serialized sum to the **critical path** — the longest
dependency-ordered path through the DAG (``critical_path``).
``simulate_dag`` validates both exactly.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Sequence, Tuple


def required_instances(t_entrance: float, k_entrance: int, t_stage: float) -> int:
    """Theorem 1: M = ceil(K * T_Y / T_X)."""
    return max(1, math.ceil(k_entrance * t_stage / t_entrance))


def plan_chain(stage_times: Sequence[float], k_entrance: int = 1) -> List[int]:
    """Instance counts for an N-stage chain keyed off the entrance stage."""
    t0 = stage_times[0]
    return [
        k_entrance if i == 0 else required_instances(t0, k_entrance, t)
        for i, t in enumerate(stage_times)
    ]


def steady_state_latency(stage_times: Sequence[float], network_s: float = 0.0) -> float:
    """T(q) = sum_i T_i + Network(q) — no queueing in a Theorem-1 plan."""
    return sum(stage_times) + network_s


# --------------------------------------------------------------------- DAGs
def topo_sort(deps: Mapping[str, Sequence[str]]) -> List[str]:
    """Kahn topological order over a stage-dependency map; raises
    ``ValueError`` on a cycle or an unknown dependency name."""
    indeg = {s: 0 for s in deps}
    succs: Dict[str, List[str]] = {s: [] for s in deps}
    for s, ds in deps.items():
        for d in ds:
            if d not in indeg:
                raise ValueError(f"stage {s!r} depends on unknown stage {d!r}")
            indeg[s] += 1
            succs[d].append(s)
    ready = [s for s, n in indeg.items() if n == 0]
    order: List[str] = []
    while ready:
        s = ready.pop(0)
        order.append(s)
        for t in succs[s]:
            indeg[t] -= 1
            if indeg[t] == 0:
                ready.append(t)
    if len(order) != len(deps):
        cyclic = sorted(s for s, n in indeg.items() if n > 0)
        raise ValueError(f"dependency cycle through stages {cyclic}")
    return order


def critical_path(
    stage_times: Mapping[str, float], deps: Mapping[str, Sequence[str]],
    network_s: float = 0.0,
) -> Tuple[float, List[str]]:
    """Longest dependency-ordered path — the steady-state latency of a
    Theorem-1-planned DAG (serialized chains pay the *sum* instead).
    Returns ``(latency, path)`` with one ``network_s`` charged per edge."""
    best: Dict[str, float] = {}
    prev: Dict[str, str] = {}
    for s in topo_sort(deps):
        t = stage_times[s]
        ds = list(deps[s])
        if not ds:
            best[s] = t
            continue
        via = max(ds, key=lambda d: best[d])
        best[s] = best[via] + network_s + t
        prev[s] = via
    end = max(best, key=lambda s: best[s])
    path = [end]
    while path[-1] in prev:
        path.append(prev[path[-1]])
    return best[end], path[::-1]


def plan_dag(
    stage_times: Mapping[str, float],
    deps: Mapping[str, Sequence[str]],
    k_entrance: int = 1,
) -> Dict[str, int]:
    """Theorem 1 applied per path: every stage sees the full admission rate
    K/T_0 (fan-out duplicates, fan-in merges — each request visits each
    stage once), where T_0 is the slowest *entrance* stage (it paces
    admission).  Identical to ``plan_chain`` on a linear chain."""
    entrances = [s for s, ds in deps.items() if not ds]
    if not entrances:
        raise ValueError("DAG has no entrance stage")
    t0 = max(max(stage_times[e], 1e-9) for e in entrances)
    return {
        s: required_instances(t0, k_entrance, max(stage_times[s], 1e-9))
        for s in topo_sort(deps)
    }


def offered_rate(t_entrance: float, k_entrance: int) -> float:
    """Admissible arrival rate K/T_X (the fast-reject threshold, §5)."""
    return k_entrance / t_entrance


@dataclass
class PipelineSimResult:
    completion_times: List[float]
    latencies: List[float]
    output_rate: float
    input_rate: float
    max_queue_depth: int

    @property
    def rate_matched(self) -> bool:
        return self.output_rate >= 0.999 * self.input_rate


def simulate_pipeline(
    stage_times: Sequence[float],
    instances_per_stage: Sequence[int],
    n_requests: int,
    arrival_period: float,
    network_s: float = 0.0,
) -> PipelineSimResult:
    """Event-driven simulation of an N-stage pipeline.

    Each stage has ``instances_per_stage[i]`` parallel servers with service
    time ``stage_times[i]``; requests arrive every ``arrival_period`` seconds
    and traverse stages in order with ``network_s`` transfer delay per hop.
    """
    n_stages = len(stage_times)
    assert len(instances_per_stage) == n_stages
    # per-stage min-heap of server-free times
    servers = [[0.0] * m for m in instances_per_stage]
    for s in servers:
        heapq.heapify(s)
    queue_depth = [0] * n_stages
    max_depth = 0

    arrivals = [i * arrival_period for i in range(n_requests)]
    completions: List[float] = []
    latencies: List[float] = []
    for a in arrivals:
        t = a
        for i in range(n_stages):
            free = heapq.heappop(servers[i])
            start = max(t, free)
            # 1ns epsilon: repeated float addition vs i*period jitter must not
            # register as queueing delay
            queue_depth[i] += 1 if start > t + 1e-9 else 0
            max_depth = max(max_depth, queue_depth[i])
            done = start + stage_times[i]
            heapq.heappush(servers[i], done)
            t = done + network_s
        completions.append(t)
        latencies.append(t - a)

    span = max(completions) - min(completions) if n_requests > 1 else 1.0
    out_rate = (n_requests - 1) / span if span > 0 else float("inf")
    in_rate = 1.0 / arrival_period
    return PipelineSimResult(
        completion_times=completions,
        latencies=latencies,
        output_rate=out_rate,
        input_rate=in_rate,
        max_queue_depth=max_depth,
    )


def simulate_dag(
    stage_times: Mapping[str, float],
    deps: Mapping[str, Sequence[str]],
    instances_per_stage: Mapping[str, int],
    n_requests: int,
    arrival_period: float,
    network_s: float = 0.0,
) -> PipelineSimResult:
    """DAG generalization of ``simulate_pipeline``: a stage becomes ready
    for a request once *all* its dependencies finished (fan-in barrier);
    independent branches run concurrently on their own servers.  Requests
    are served FIFO per stage, matching the ring-buffer data plane.  A
    request completes when its terminal stage (unique sink) finishes."""
    order = topo_sort(deps)
    sinks = [s for s in order
             if not any(s in deps[t] for t in order)]
    servers = {s: [0.0] * instances_per_stage[s] for s in order}
    for h in servers.values():
        heapq.heapify(h)
    queue_depth = {s: 0 for s in order}
    max_depth = 0

    completions: List[float] = []
    latencies: List[float] = []
    for i in range(n_requests):
        a = i * arrival_period
        done: Dict[str, float] = {}
        for s in order:
            ds = deps[s]
            ready = a if not ds else max(done[d] for d in ds) + network_s
            free = heapq.heappop(servers[s])
            start = max(ready, free)
            queue_depth[s] += 1 if start > ready + 1e-9 else 0
            max_depth = max(max_depth, queue_depth[s])
            done[s] = start + stage_times[s]
            heapq.heappush(servers[s], done[s])
        t = max(done[s] for s in sinks)
        completions.append(t)
        latencies.append(t - a)

    span = max(completions) - min(completions) if n_requests > 1 else 1.0
    out_rate = (n_requests - 1) / span if span > 0 else float("inf")
    return PipelineSimResult(
        completion_times=completions,
        latencies=latencies,
        output_rate=out_rate,
        input_rate=1.0 / arrival_period,
        max_queue_depth=max_depth,
    )

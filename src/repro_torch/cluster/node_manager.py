"""NodeManager (§8): centralized orchestrator.

Maintains roles + network locations of all instances, receives periodic GPU
utilization reports, and performs the §8.2 elastic assignment loop:

  1. instances report utilization            (report_utilization)
  2. NM averages per stage over a window     (_stage_utilization)
  3. busiest stage identified                 (plan_rebalance)
  4. util > threshold -> assign an instance  (from the Idle Instance Pool,
     or steal from the least-utilized stage below `steal_below`)
  5. role/tasks/next-hop state delivered      (instances poll get_assignment)

The live driver of that loop is ``ControlLoop`` (started by
``WorkflowSet.start()``): it evicts instances whose utilization reports
stopped arriving (liveness), runs one rebalance step per tick against the
real traffic, and pushes Theorem-1 capacity updates into every
NM-managed proxy ``RequestMonitor`` (§5: the NM "continuously calculates
K" as instances come and go).

Reassignment is two-phase when ``drain=True``: the instance keeps its new
stage in ``get_assignment`` immediately, but it is *excluded from routing
for both stages* until it confirms it has drained and handed off its
queued old-stage messages (``confirm_reassignment``).  This is what makes
a mid-flight reassignment safe — no message is ever routed to, or executed
by, an instance under the wrong stage identity.

Primary/backup replication with Paxos election lives in NMCluster.
Workflows are stage **DAGs** keyed by app_id (docs/workflows.md): each
``StageSpec`` may name its dependencies; ``deps=None`` defaults to the
previous stage in the list, so every chain spec is unchanged.  Routing is
per-edge (``successor_stages`` + ``stage_instances``); fan-in stages are
assembled in the set-level JoinTable.  Instance sharing (§8.3) falls out
naturally: a stage name can appear in several workflows and its instances
serve all of them.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis.runtime import make_lock, make_rlock
from repro_torch.cluster.paxos import elect_primary


@dataclass
class StageSpec:
    name: str
    fn: Optional[Callable] = None        # payload -> payload (user code)
    exec_time_s: float = 0.0             # pipelining hint (Theorem 1)
    mode: str = "IM"                     # IM | CM (§4.3)
    # Upstream stage names.  None (default) = the previous stage in the
    # workflow's stage list, so a plain list of StageSpecs stays the linear
    # chain it always was.  [] = entrance stage (fed by the proxy); two or
    # more names = fan-in stage assembled in the JoinTable.
    deps: Optional[List[str]] = None


@dataclass
class WorkflowSpec:
    """A workflow's stage DAG.  ``stages`` is frozen once the spec is
    registered with a NodeManager — the derived shape (deps/successors/
    index maps) is computed once and cached; routing hits it per message."""

    app_id: int
    name: str
    stages: List[StageSpec]

    def stage_names(self) -> List[str]:
        return [s.name for s in self.stages]

    # ------------------------------------------------------------ DAG shape
    def _shape(self) -> Tuple[Dict[str, List[str]], Dict[str, List[str]],
                              Dict[str, int]]:
        """(deps, successors, name->index), built once per spec."""
        cache = self.__dict__.get("_shape_cache")
        if cache is None:
            deps: Dict[str, List[str]] = {}
            for i, s in enumerate(self.stages):
                if s.deps is None:
                    deps[s.name] = [self.stages[i - 1].name] if i else []
                else:
                    deps[s.name] = list(s.deps)
            succs: Dict[str, List[str]] = {s.name: [] for s in self.stages}
            for s in self.stages:
                for d in deps[s.name]:
                    if d in succs:
                        succs[d].append(s.name)
            index = {s.name: i for i, s in enumerate(self.stages)}
            cache = (deps, succs, index)
            self.__dict__["_shape_cache"] = cache
        return cache

    def stage_index(self, name: str) -> int:
        try:
            return self._shape()[2][name]
        except KeyError:
            raise KeyError(f"stage {name!r} not in workflow {self.app_id}")

    def resolved_deps(self) -> Dict[str, List[str]]:
        """Per-stage dependency lists with the chain default applied:
        ``deps=None`` means the previous stage ([] for the first)."""
        return {k: list(v) for k, v in self._shape()[0].items()}

    def deps_of(self, stage: str) -> List[str]:
        return list(self._shape()[0][stage])

    def successors(self, stage: str) -> List[str]:
        """Downstream stages fed by `stage`, in definition order (the
        per-edge fan-out set; empty for the terminal stage)."""
        return list(self._shape()[1][stage])

    def entrance_stages(self) -> List[str]:
        """Stages with no dependencies — the proxy fans each admitted
        request out to every one of them."""
        deps = self._shape()[0]
        return [s.name for s in self.stages if not deps[s.name]]

    def terminal_stage(self) -> str:
        """The unique sink whose output is the request's result."""
        deps = self.resolved_deps()
        fed = {d for ds in deps.values() for d in ds}
        sinks = [s.name for s in self.stages if s.name not in fed]
        if len(sinks) != 1:
            raise ValueError(f"workflow {self.name!r} has sinks {sinks}; "
                             "exactly one terminal stage is required")
        return sinks[0]

    def validate(self) -> None:
        """Reject malformed specs at registration: duplicate/unknown stage
        names, cycles, no entrance, or multiple sinks."""
        names = self.stage_names()
        if len(set(names)) != len(names):
            raise ValueError(f"workflow {self.name!r} has duplicate stage names")
        from repro_torch.core.pipeline_planner import topo_sort

        deps = self.resolved_deps()
        topo_sort(deps)  # raises on unknown deps / cycles
        if not self.entrance_stages():
            raise ValueError(f"workflow {self.name!r} has no entrance stage")
        self.terminal_stage()  # raises unless exactly one sink


@dataclass
class InstanceInfo:
    name: str
    role: str = "workflow"               # proxy | workflow | database
    stage: Optional[str] = None          # assigned stage name (None = idle pool)
    location: str = ""                   # fabric region of its inbox
    utilization: deque = field(default_factory=lambda: deque(maxlen=64))
    version: int = 0                     # bumped on reassignment
    last_report: float = field(default_factory=time.monotonic)
    draining: bool = False               # reassigned, handoff not yet confirmed


class NodeManager:
    def __init__(self, *, scale_threshold: float = 0.85, steal_below: float = 0.70,
                 window: int = 8):
        self._lock = make_rlock("NodeManager._lock")
        self.instances: Dict[str, InstanceInfo] = {}  # guarded_by: _lock
        self.workflows: Dict[int, WorkflowSpec] = {}  # guarded_by: _lock
        self.scale_threshold = scale_threshold
        self.steal_below = steal_below
        self.window = window
        # audit log of (name, old_stage, new_stage)
        self.reassignments: List[Tuple[str, Optional[str], str]] = []  # guarded_by: _lock
        self._topology_version = 0  # routing epoch; guarded_by: _lock

    # ------------------------------------------------------------ registry
    def register_instance(self, name: str, role: str = "workflow",
                          location: str = "") -> None:
        with self._lock:
            self.instances[name] = InstanceInfo(name=name, role=role,
                                                location=location or name)
            self._topology_version += 1

    def register_workflow(self, wf: WorkflowSpec) -> None:
        wf.validate()  # malformed DAGs (cycles, multi-sink) never enter routing
        with self._lock:
            self.workflows[wf.app_id] = wf
            # A new workflow changes routing (next_hops now resolve for its
            # app ids) — routers caching by topology version must see it.
            self._topology_version += 1

    def assign(self, name: str, stage: Optional[str], *, drain: bool = False) -> None:
        """Reassign an instance.  With ``drain=True`` (the live control
        loop path) the instance is marked draining: it is excluded from
        routing for *both* the old and the new stage until it calls
        ``confirm_reassignment`` after handing off its queued messages."""
        with self._lock:
            info = self.instances[name]
            self.reassignments.append((name, info.stage, stage or "idle"))
            info.draining = bool(drain and info.stage is not None
                                 and info.stage != stage)
            info.stage = stage
            info.version += 1
            self._topology_version += 1

    def confirm_reassignment(self, name: str) -> None:
        """Instance-side acknowledgement that the drain-and-handoff for its
        last reassignment finished: its inbox is now registered under the
        new stage (it re-enters routing)."""
        with self._lock:
            info = self.instances.get(name)
            if info is not None and info.draining:
                info.draining = False
                self._topology_version += 1

    def evict_instance(self, name: str) -> None:
        """Liveness eviction: remove a dead instance from the registry and
        from every next-hop set (topology bump invalidates router caches)."""
        with self._lock:
            info = self.instances.pop(name, None)
            if info is not None:
                self.reassignments.append((name, info.stage, "evicted"))
                self._topology_version += 1

    # ------------------------------------------------------------- queries
    def topology_version(self) -> int:
        """Monotonic counter bumped on every routing-relevant change; the
        transport Router uses it to invalidate cached producers."""
        with self._lock:
            return self._topology_version

    def get_assignment(self, name: str) -> Tuple[Optional[str], int]:
        """-> (stage name or None for idle, version)."""
        with self._lock:
            info = self.instances[name]
            return info.stage, info.version

    def stage_fn(self, app_id: int, stage: str):
        with self._lock:
            wf = self.workflows[app_id]
            for s in wf.stages:
                if s.name == stage:
                    return s
            raise KeyError(f"stage {stage} not in workflow {app_id}")

    def stage_name(self, app_id: int, stage_idx: int) -> str:
        """Resolve a message's stage *index* to its stage name.  This is the
        stage identity a message carries through the pipeline — instances
        must execute/route by it, never by their own (mutable) assignment."""
        with self._lock:
            return self.workflows[app_id].stages[stage_idx].name

    def stage_instances(self, stage: str) -> List[str]:
        with self._lock:
            return [n for n, i in self.instances.items()
                    if i.stage == stage and i.role == "workflow"
                    and not i.draining]

    def idle_instances(self) -> List[str]:
        with self._lock:
            return [n for n, i in self.instances.items()
                    if i.stage is None and i.role == "workflow"]

    def successor_stages(self, app_id: int, stage: str) -> List[str]:
        """Per-edge routing: the downstream stages fed by `stage` in this
        app's DAG (empty for the terminal stage)."""
        with self._lock:
            return self.workflows[app_id].successors(stage)

    def stage_deps(self, app_id: int, stage: str) -> List[str]:
        """The upstream stages a fan-in join must assemble before `stage`
        can run (the JoinTable's ``expected`` set)."""
        with self._lock:
            return self.workflows[app_id].deps_of(stage)

    def next_hops(self, app_id: int, stage: str) -> List[str]:
        """Routing: the union of instances across `stage`'s successor
        stages (§4.5) — one set per edge via ``successor_stages`` +
        ``stage_instances`` — or the database instances after the terminal
        stage."""
        with self._lock:
            succs = self.workflows[app_id].successors(stage)
            if not succs:
                return [n for n, i in self.instances.items() if i.role == "database"]
            hops: List[str] = []
            for s in succs:
                hops.extend(n for n in self.stage_instances(s) if n not in hops)
            return hops

    def location(self, name: str) -> str:
        with self._lock:
            return self.instances[name].location

    def proxies(self) -> List[str]:
        with self._lock:
            return [n for n, i in self.instances.items() if i.role == "proxy"]

    # ----------------------------------------------------------- monitoring
    def report_utilization(self, name: str, util: float) -> None:
        with self._lock:
            info = self.instances.get(name)
            if info is None:
                # A report from an instance the NM evicted (false-positive
                # liveness timeout, or a replica that missed the register):
                # re-admit it to the idle pool rather than crash its manager.
                self.register_instance(name, role="workflow")
                info = self.instances[name]
            info.utilization.append(util)
            info.last_report = time.monotonic()

    def dead_instances(self, timeout_s: float, now: Optional[float] = None) -> List[str]:
        """Workflow instances whose utilization reports stopped arriving."""
        now = time.monotonic() if now is None else now
        with self._lock:
            return [n for n, i in self.instances.items()
                    if i.role == "workflow" and now - i.last_report > timeout_s]

    def _stage_utilization(self) -> Dict[str, float]:
        with self._lock:
            per_stage: Dict[str, List[float]] = defaultdict(list)
            for info in self.instances.values():
                if info.stage and info.role == "workflow":
                    recent = list(info.utilization)[-self.window:]
                    per_stage[info.stage].append(
                        sum(recent) / len(recent) if recent else 0.0
                    )
            return {s: sum(v) / len(v) for s, v in per_stage.items()}

    # --------------------------------------------------- elastic assignment
    def plan_rebalance(self) -> Optional[Tuple[str, str]]:
        """Pure §8.2 decision step (no mutation): returns (instance, stage)
        if one should move.  Split from the mutation so NMCluster can plan
        on the primary and replicate the resulting ``assign`` — every
        replica applies the identical write stream."""
        with self._lock:
            utils = self._stage_utilization()
            if not utils:
                return None
            busiest, busy_util = max(utils.items(), key=lambda kv: kv[1])
            if busy_util < self.scale_threshold:
                return None
            # 1) idle pool first
            idle = self.idle_instances()
            if idle:
                return idle[0], busiest
            # 2) steal from the least-utilized stage (Figure 10)
            donors = [(s, u) for s, u in utils.items()
                      if s != busiest and u < self.steal_below]
            if not donors:
                return None
            donor_stage = min(donors, key=lambda kv: kv[1])[0]
            donor_insts = self.stage_instances(donor_stage)
            if len(donor_insts) <= 1:
                return None  # never empty a stage
            return donor_insts[-1], busiest

    def rebalance(self, *, drain: bool = False) -> Optional[Tuple[str, str]]:
        """One §8.2 step. Returns (instance, stage) if a reassignment happened."""
        move = self.plan_rebalance()
        if move is not None:
            self.assign(move[0], move[1], drain=drain)
        return move

    # ----------------------------------------------------------- pipelining
    def plan_stage_instances(self, app_id: int, k_entrance: int = 1) -> Dict[str, int]:
        """Theorem-1 instance counts for a workflow — critical-path planning
        (Theorem 1 applied per path) so DAG and chain specs both rate-match."""
        from repro_torch.core.pipeline_planner import plan_dag

        with self._lock:
            wf = self.workflows[app_id]
        times = {s.name: max(s.exec_time_s, 1e-9) for s in wf.stages}
        return plan_dag(times, wf.resolved_deps(), k_entrance)

    def entrance_capacity(self) -> Optional[Tuple[float, float]]:
        """Theorem-1 admissible capacity ``(t_entrance_s, k_entrance)`` from
        *live* instance counts.  A workflow's rate is the min over its
        entrance stages of k_i/t_i (every admitted request is fanned out to
        all of them).  Workflows sharing the same entrance set count once
        (§8.3).  With one distinct entrance stage this is the theorem's
        exact (T_X, K); otherwise it degrades to ``(1.0, Σ min_i k_i/t_i)``
        — the aggregate rate with the same ``k/t`` semantics."""
        with self._lock:
            # Entrance groups, merged transitively on any shared stage so a
            # shared entrance's instances are never counted twice (§8.3):
            # disjoint workflows contribute independent rate terms; a group
            # with overlap is conservatively capped by its slowest member.
            groups: List[Dict[str, float]] = []
            for wf in self.workflows.values():
                if not wf.stages:
                    continue
                merged = {
                    n: max(wf.stages[wf.stage_index(n)].exec_time_s, 1e-9)
                    for n in wf.entrance_stages()
                }
                rest = []
                for g in groups:
                    if set(g) & set(merged):
                        # a stage declared by several workflows keeps its
                        # slowest exec time — capacity must not depend on
                        # registration order
                        merged = {n: max(g.get(n, 0.0), merged.get(n, 0.0))
                                  for n in set(g) | set(merged)}
                    else:
                        rest.append(g)
                groups = rest + [merged]
            if not groups:
                return None
            if len(groups) == 1 and len(groups[0]) == 1:
                name, t = next(iter(groups[0].items()))
                return t, float(len(self.stage_instances(name)))
            rate = sum(
                min(len(self.stage_instances(n)) / t for n, t in g.items())
                for g in groups
            )
            return 1.0, rate

    # --------------------------------------------------------- replication
    @staticmethod
    def _copy_info(info: InstanceInfo) -> InstanceInfo:
        return InstanceInfo(
            name=info.name, role=info.role, stage=info.stage,
            location=info.location,
            utilization=deque(info.utilization, maxlen=64),
            version=info.version, last_report=info.last_report,
            draining=info.draining,
        )

    def absorb(self, other: "NodeManager") -> None:
        """State carry-over (§8.1): merge another replica's registrations and
        assignments into this one.  Per instance the higher assignment
        version wins; workflows union.  Entries are copied — replicas must
        never share mutable InstanceInfo objects, or one replicated write
        would apply twice.  Used by NMCluster.maybe_elect so a newly
        elected primary serves the most complete state any live replica
        saw."""
        # Canonical acquisition order: both replicas' locks are the same
        # lock class, and A.absorb(B) racing B.absorb(A) with naive
        # self-then-other ordering is a textbook symmetric deadlock (today
        # NMCluster._elect_lock serializes callers, but absorb must not
        # depend on its caller for soundness).  id() gives a total order
        # that both racers agree on.
        first, second = ((self, other) if id(self) <= id(other)
                         else (other, self))
        with first._lock, second._lock:  # analysis: ignore[lock-order] -- id()-ordered above
            self._absorb_locked(other)

    def _absorb_locked(self, other: "NodeManager") -> None:
        for app_id, wf in other.workflows.items():
            self.workflows.setdefault(app_id, wf)
        for name, info in other.instances.items():
            mine = self.instances.get(name)
            if mine is None or info.version > mine.version:
                self.instances[name] = self._copy_info(info)
        self._topology_version = (
            max(self._topology_version, other._topology_version) + 1
        )

    def sync_from(self, primary: "NodeManager") -> None:
        """Recovered-replica resync: replace local state with the primary's
        (the replica missed every write while it was down)."""
        with primary._lock:
            instances = {n: self._copy_info(i)
                         for n, i in primary.instances.items()}
            workflows = dict(primary.workflows)
            version = primary._topology_version
            log = list(primary.reassignments)
        with self._lock:
            self.instances = instances
            self.workflows = workflows
            self._topology_version = version
            self.reassignments = log


class ControlLoop:
    """§8 live control plane, one thread per Workflow Set.

    Each tick:
      1. liveness   — instances whose utilization reports stopped arriving
                      for ``liveness_timeout_s`` are evicted (topology bump
                      drops them from every next-hop set and router cache);
      2. rebalance  — one §8.2 step against the live utilization window;
                      moves use drain-and-handoff (``assign(drain=True)``)
                      so queued messages are never executed under the
                      wrong stage identity;
      3. capacity   — Theorem-1 ``(T_X, K)`` from live entrance-stage
                      instance counts is pushed into every NM-managed
                      proxy RequestMonitor (§5).
    """

    def __init__(self, nm, *, monitors=(), interval_s: float = 0.05,
                 liveness_timeout_s: float = 2.0, drain: bool = True):
        self.nm = nm
        # Sequence, or a zero-arg callable re-read every tick so monitors of
        # proxies added after start() still receive capacity pushes.
        self._monitors_src = monitors if callable(monitors) else (
            lambda frozen=list(monitors): frozen)
        self.interval_s = interval_s
        self.liveness_timeout_s = liveness_timeout_s
        self.drain = drain
        self.moves: List[Tuple[str, str]] = []
        self.evicted: List[str] = []
        self.errors: List[str] = []  # repr of step() failures (loop survives)
        self.capacity_pushes = 0
        self.steps = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def monitors(self) -> List:
        return list(self._monitors_src())

    def step(self) -> None:
        self.steps += 1
        for name in self.nm.dead_instances(self.liveness_timeout_s):
            self.nm.evict_instance(name)
            self.evicted.append(name)
        move = self.nm.plan_rebalance()
        if move is not None:
            self.nm.assign(move[0], move[1], drain=self.drain)
            self.moves.append(move)
        cap = self.nm.entrance_capacity()
        if cap is not None:
            for mon in self.monitors:
                if getattr(mon, "nm_managed", False):
                    mon.update_capacity(cap[0], cap[1])
                    self.capacity_pushes += 1

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.step()
            except Exception as e:  # noqa: BLE001
                # A failed tick must not kill the control plane — eviction,
                # rebalance and capacity pushes would all silently stop.
                if len(self.errors) < 64:
                    self.errors.append(repr(e))
            self._stop.wait(self.interval_s)

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="nm-control")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


#: NodeManager methods that mutate state — NMCluster fans these out to every
#: live replica so backups track the primary write-for-write (§8.1).
_NM_WRITES = (
    "register_instance",
    "register_workflow",
    "assign",
    "confirm_reassignment",
    "evict_instance",
    "report_utilization",
)


def _make_replicated(fn_name: str):
    def write(self, *args, **kwargs):
        return self.replicate_write(fn_name, *args, **kwargs)

    write.__name__ = fn_name
    write.__doc__ = f"Replicated NodeManager.{fn_name} (fan-out to live replicas)."
    return write


class NMCluster:
    """Primary-backup NM replicas with heartbeat + Paxos election (§8.1).

    Quacks like a NodeManager: reads delegate to the elected primary
    (electing one on demand if the primary died), writes fan out through
    ``replicate_write`` to every live replica.  A WorkflowSet can therefore
    be constructed directly on a cluster (``WorkflowSet(nm=NMCluster())``)
    and survive a primary failure mid-traffic."""

    def __init__(self, n_replicas: int = 3, heartbeat_timeout: float = 3.0,
                 **nm_kwargs):
        self.replicas = [NodeManager(**nm_kwargs) for _ in range(n_replicas)]
        self.node_ids = list(range(n_replicas))
        self.primary_id: Optional[int] = 0
        self.heartbeat_timeout = heartbeat_timeout
        self.last_heartbeat = time.monotonic()
        self.alive = set(self.node_ids)
        self._elect_lock = make_lock("NMCluster._elect_lock")

    @property
    def primary(self) -> NodeManager:
        assert self.primary_id is not None
        return self.replicas[self.primary_id]

    def _require_primary(self) -> NodeManager:
        """Primary for reads; any caller noticing a missing leader triggers
        the election (paper: 'any replica noticing a missing heartbeat')."""
        if self.primary_id is None:
            self.maybe_elect()
        return self.replicas[self.primary_id]

    def heartbeat(self) -> None:
        self.last_heartbeat = time.monotonic()

    def fail(self, node_id: int) -> None:
        self.alive.discard(node_id)
        if node_id == self.primary_id:
            self.primary_id = None

    def recover(self, node_id: int, *, resync: bool = True) -> None:
        """Bring a failed replica back.  With ``resync`` (default) it copies
        the primary's full state — it missed every replicated write while it
        was down.  ``resync=False`` models a replica rejoining before the
        resync completes (its stale state is what maybe_elect's union
        carry-over protects against)."""
        self.alive.add(node_id)
        if resync and self.primary_id is not None and node_id != self.primary_id:
            self.replicas[node_id].sync_from(self.primary)

    def maybe_elect(self, *, drop: float = 0.0, seed: int = 0) -> int:
        """Any replica noticing a missing leader triggers a Paxos election."""
        with self._elect_lock:
            if self.primary_id is not None:
                return self.primary_id
            candidates = sorted(self.alive)
            decided = elect_primary(candidates, drop=drop, seed=seed)
            assert decided and len(set(decided)) == 1, "Paxos safety violated"
            winner = decided[0]
            # State carry-over (§8.1): the new leader adopts the union of
            # registrations/assignments across live replicas, so even if it
            # personally missed writes (it was down and rejoined un-resynced)
            # it serves every pre-failure instance and workflow.
            for i in candidates:
                if i != winner:
                    self.replicas[winner].absorb(self.replicas[i])
            self.primary_id = winner
            return winner

    def replicate_write(self, fn_name: str, *args, **kwargs) -> None:
        """Writes go to primary and are propagated to backups (§8.1).  The
        primary applies first — a write it rejects is invalid and the error
        propagates.  A backup that fails the write has diverged (e.g. it
        rejoined before its resync finished) and is brought back in line by
        a full resync from the post-write primary, so the write stream
        never forks."""
        if not self.alive:
            raise ConnectionError("no NM replicas alive")
        if self.primary_id is None:
            self.maybe_elect()
        primary = self.primary_id
        getattr(self.replicas[primary], fn_name)(*args, **kwargs)
        for i in sorted(self.alive):
            if i == primary:
                continue
            try:
                getattr(self.replicas[i], fn_name)(*args, **kwargs)
            except Exception:  # noqa: BLE001 — diverged backup, re-sync it
                self.replicas[i].sync_from(self.replicas[primary])

    def rebalance(self, *, drain: bool = False) -> Optional[Tuple[str, str]]:
        """Plan on the primary, replicate the resulting assign — replicas
        see one write stream and stay deterministic."""
        move = self._require_primary().plan_rebalance()
        if move is not None:
            self.replicate_write("assign", move[0], move[1], drain=drain)
        return move

    def __getattr__(self, attr: str):
        # Reads (get_assignment, next_hops, stage_fn, topology_version,
        # instances, workflows, ...) delegate to the elected primary.
        if attr.startswith("_"):
            raise AttributeError(attr)
        return getattr(self._require_primary(), attr)


for _name in _NM_WRITES:
    setattr(NMCluster, _name, _make_replicated(_name))

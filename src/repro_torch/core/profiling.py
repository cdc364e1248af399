"""Per-request latency profiler for the workflow data plane.

Every message that crosses a stage passes six checkpoints:

    enqueue   — producer's ring append landed (Channel.send / send_many)
    dequeue   — the target scheduler unpacked it from its inbox
    dispatch  — the scheduler handed the (coalesced) batch to execution
    fn_start  — the stage function began
    fn_end    — the stage function returned
    delivered — per-request results were routed onward (or stored)

The profiler records one span per ``(uid, stage index)`` and folds it,
on ``delivered``, into per-stage phase samples:

    ring      enqueue  -> dequeue    (ring residency + scheduler wakeup)
    coalesce  dequeue  -> dispatch   (microbatch formation wait)
    sched     dispatch -> fn_start   (worker handoff / queue wait)
    stage_fn  fn_start -> fn_end     (the user stage function)
    deliver   fn_end   -> delivered  (fan-out routing, joins, DB store)

The sum of the phases is the request's per-hop latency, so a bench run
attributes the disaggregation overhead line-by-line — the gap vs the
monolithic pipeline is exactly ``sum(phases) - stage_fn`` per hop.

Disabled (the default) the cost at every stamp site is one attribute
load and a falsy branch; no allocation, no lock.  Enabled, stamps take a
small module lock — the profiler is a diagnosis tool (benches, the
``--profile-latency`` serve flag), not an always-on counter.

One process-wide instance (``profiler()``) is shared by the transport
and cluster layers, mirroring how ``lock_stats_snapshot`` feeds
``WorkflowSet.transport_stats()`` — which surfaces ``snapshot()`` as
``ChannelStats.latency`` when the profiler is enabled.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

EVENTS: Tuple[str, ...] = (
    "enqueue", "dequeue", "dispatch", "fn_start", "fn_end", "delivered",
)
_EV_IDX = {e: i for i, e in enumerate(EVENTS)}

#: (phase name, start event, end event) — reported in this order.
PHASES: Tuple[Tuple[str, str, str], ...] = (
    ("ring", "enqueue", "dequeue"),
    ("coalesce", "dequeue", "dispatch"),
    ("sched", "dispatch", "fn_start"),
    ("stage_fn", "fn_start", "fn_end"),
    ("deliver", "fn_end", "delivered"),
)
_PHASE_IDX = [(name, _EV_IDX[a], _EV_IDX[b]) for name, a, b in PHASES]


def _pct(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile of an already-sorted sample list."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, int(q * len(sorted_vals))))
    return sorted_vals[i]


class LatencyProfiler:
    """Span recorder keyed by ``(uid_hex, stage index)``.

    ``stamp`` is idempotent per (span, event): the first timestamp wins,
    so a message fanned to several successor edges folds exactly once.
    Spans that never reach ``delivered`` (drops, shutdown) are discarded
    by ``reset``/``snapshot`` accounting as ``open_spans``.
    """

    def __init__(self, max_samples_per_phase: int = 8192):
        self.enabled = False
        self.max_samples_per_phase = max_samples_per_phase
        self._mu = threading.Lock()
        # (uid_hex, stage_idx) -> [t per event or None]; guarded_by: _mu
        self._open: Dict[Tuple[str, int], List[Optional[float]]] = {}
        # stage label -> phase name -> samples (seconds); guarded_by: _mu
        self._samples: Dict[str, Dict[str, List[float]]] = {}
        self.folded = 0       # completed spans; guarded_by: _mu
        self.discarded = 0    # samples beyond max_samples_per_phase

    # ------------------------------------------------------------ lifecycle
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._mu:
            self._open.clear()
            self._samples.clear()
            self.folded = 0
            self.discarded = 0

    def open_spans(self) -> int:
        with self._mu:
            return len(self._open)

    # ------------------------------------------------------------- stamping
    def stamp(self, uid_hex: str, stage_idx: int, event: str, *,
              label: Optional[str] = None, t: Optional[float] = None) -> None:
        """Record ``event`` for one message's current hop.  ``label`` names
        the stage in the report and is only consulted on ``delivered``
        (the instance side knows the stage name; the transport side does
        not).  Callers on the hot path must guard with ``self.enabled``
        themselves to keep the disabled cost at one branch."""
        if not self.enabled:
            return
        if t is None:
            t = time.monotonic()
        i = _EV_IDX[event]
        key = (uid_hex, stage_idx)
        with self._mu:
            rec = self._open.get(key)
            if rec is None:
                rec = self._open[key] = [None] * len(EVENTS)
            if rec[i] is None:
                rec[i] = t
            if i == len(EVENTS) - 1:  # delivered: fold and close the span
                del self._open[key]
                self._fold_locked(label or f"stage{stage_idx}", rec)

    def _fold_locked(self, label: str, rec: List[Optional[float]]) -> None:
        self.folded += 1
        phases = self._samples.setdefault(label, {})
        for name, a, b in _PHASE_IDX:
            ta, tb = rec[a], rec[b]
            if ta is None or tb is None:
                continue
            samples = phases.setdefault(name, [])
            if len(samples) >= self.max_samples_per_phase:
                self.discarded += 1
                continue
            samples.append(max(tb - ta, 0.0))

    # ------------------------------------------------------------ reporting
    def snapshot(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        """``{stage: {phase: {n, mean_us, p50_us, p90_us, p99_us, max_us}}}``
        — the percentile form ``WorkflowSet.transport_stats()`` exposes as
        ``ChannelStats.latency``."""
        with self._mu:
            copied = {s: {ph: list(v) for ph, v in phases.items()}
                      for s, phases in self._samples.items()}
        out: Dict[str, Dict[str, Dict[str, float]]] = {}
        for stage, phases in copied.items():
            rep: Dict[str, Dict[str, float]] = {}
            for name, _a, _b in _PHASE_IDX:
                vals = sorted(phases.get(name, ()))
                if not vals:
                    continue
                rep[name] = {
                    "n": float(len(vals)),
                    "mean_us": sum(vals) / len(vals) * 1e6,
                    "p50_us": _pct(vals, 0.50) * 1e6,
                    "p90_us": _pct(vals, 0.90) * 1e6,
                    "p99_us": _pct(vals, 0.99) * 1e6,
                    "max_us": vals[-1] * 1e6,
                }
            out[stage] = rep
        return out

    def timeline(self, stat: str = "p50_us") -> List[Tuple[str, Dict[str, float]]]:
        """Per-stage phase values (milliseconds) in fold order — the bench's
        stage-timeline breakdown row."""
        snap = self.snapshot()
        return [(stage, {ph: v[stat] / 1e3 for ph, v in phases.items()})
                for stage, phases in snap.items()]

    def timeline_compact(self, stat: str = "p50_us") -> str:
        """One-line form for a bench row's ``derived`` field:
        ``stage[ring=..,coalesce=..,sched=..,stage_fn=..,deliver=..]|...``
        (values in ms)."""
        parts = []
        for stage, phases in self.timeline(stat):
            inner = ",".join(f"{ph}={phases[ph]:.2f}"
                             for ph, _a, _b in PHASES if ph in phases)
            parts.append(f"{stage}[{inner}]")
        return "|".join(parts)


_PROFILER = LatencyProfiler()


def profiler() -> LatencyProfiler:
    """The process-wide profiler instance (disabled by default)."""
    return _PROFILER

"""Continuous-stage protocol: deferred results and token-boundary streaming.

A normal workflow stage maps one input message to one result synchronously.
A *continuous* stage (the decode half of llm_disagg, docs/disaggregation.md)
instead absorbs requests into long-lived internal state — a slot batch —
and emits each request's result many scan segments later.  The protocol
between such a stage fn and ``WorkflowInstance``:

  * the fn is marked ``fn.continuous = True`` and is called per message as
    ``fn(payload, uid=...)``;
  * a call may return ``DEFERRED``: the instance parks the message (it is
    neither delivered nor counted processed) and keeps the request in the
    §9 ledger until the fn later completes or abandons it;
  * the scheduler *pumps* the fn between inbox polls: ``fn.tick()`` runs
    one decode segment and returns ``[(uid, result), ...]`` for requests
    that finished — each is then delivered exactly like a synchronous
    stage result, under its original message identity;
  * ``fn.pending()`` reports parked work so the instance never parks on
    the doorbell while slots are still decoding (tick cadence *is* the
    token-boundary admission cadence);
  * on drain/stop, ``fn.abandon()`` returns the uids of requests still in
    flight so the instance can tombstone them (dropped, never silently
    stranded — ``submitted == stored ∪ dead_uids()`` stays an invariant).

``DEFERRED`` lives here, in core, so both the cluster layer and serving
stage fns can import it without a dependency cycle.
"""
from __future__ import annotations


class _Deferred:
    """Sentinel: the stage has absorbed this message; its result will be
    emitted by a later ``tick()``."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return "<DEFERRED>"


DEFERRED = _Deferred()


def is_continuous(fn) -> bool:
    """True if ``fn`` implements the continuous-stage protocol."""
    return bool(getattr(fn, "continuous", False))

"""Blocking-while-locked lint.

A ``with <lock>:`` body must not perform operations that can block or
stall for unbounded time while other threads wait on the lock:

* ``time.sleep(...)`` — always flagged;
* future/queue waits: ``.result()``, ``.join()``, ``.wait()``,
  ``.get(...)`` on a queue-like receiver;
* ring appends: ``append`` / ``append_many`` / ``send`` / ``send_parts``
  / ``send_many`` when the receiver looks like a producer, channel,
  router, or ring — the §6.1 software lock already serialises ring
  access, and a CPU lock held across an append turns a slow consumer
  into repo-wide head-of-line blocking (and, worse, a producer stalled
  under a Python lock is exactly what triggers spurious ring-lock
  takeovers and the Case-2 clobber);
* the consumer doorbell: ``notify`` on a ring-like receiver — the hook
  is arbitrary user code (typically ``Event.set``, but nothing enforces
  that) and its contract (ring_buffer.set_notify, docs/perf.md) is
  *strictly after the ring lock is released*; firing it under any ring
  or channel lock reintroduces the stalled-producer takeover hazard the
  notify design exists to avoid;
* one-sided fabric verbs: ``writev`` / ``compare_and_swap`` /
  ``fetch_add`` always; ``read`` / ``write`` / ``read_u64`` /
  ``write_u64`` when the receiver mentions a fabric;
* ``block_until_ready`` — a device sync under a host lock.

The pass is lexical: it does not follow calls, so a helper that sleeps
must itself be called under a lock to be caught (documented limitation;
see docs/static_analysis.md).  Rule name: ``blocking-under-lock``.
"""
from __future__ import annotations

import ast
from typing import List

from repro_torch.analysis.common import (SourceFile, Violation, attr_chain,
                                   filter_suppressed, looks_like_lock)

RULE = "blocking-under-lock"

ALWAYS_BLOCKING_METHODS = {
    "writev", "compare_and_swap", "fetch_add", "append_many",
    "block_until_ready", "result",
}
FABRIC_METHODS = {"read", "write", "read_u64", "write_u64"}
RING_METHODS = {"append", "send", "send_parts", "send_many", "notify"}
RING_RECEIVER_HINTS = ("producer", "channel", "router", "ring", "chan",
                       "inbox", "buf")
#: receivers matched exactly (or as a trailing segment) — "rb" as a
#: substring hint would false-positive on names like "verbose"
RING_RECEIVER_EXACT = ("rb",)
WAIT_METHODS = {"join", "wait"}


def _ring_receiver(recv: str) -> bool:
    if any(h in recv for h in RING_RECEIVER_HINTS):
        return True
    return any(recv == e or recv.endswith("." + e)
               for e in RING_RECEIVER_EXACT)


def _call_violation(node: ast.Call, path: str) -> Violation | None:
    fn = node.func
    dotted = attr_chain(fn)
    if dotted == "time.sleep" or dotted.endswith(".sleep"):
        return Violation(RULE, path, node.lineno,
                         "time.sleep() inside a `with lock:` body")
    if not isinstance(fn, ast.Attribute):
        return None
    meth = fn.attr
    recv = attr_chain(fn.value).lower()
    if meth in ALWAYS_BLOCKING_METHODS:
        return Violation(RULE, path, node.lineno,
                         f"blocking call .{meth}() while holding a lock")
    if meth in FABRIC_METHODS and "fabric" in recv:
        return Violation(RULE, path, node.lineno,
                         f"one-sided fabric op {recv}.{meth}() while "
                         "holding a lock")
    if meth in RING_METHODS and _ring_receiver(recv):
        return Violation(RULE, path, node.lineno,
                         f"ring/transport op {recv}.{meth}() while "
                         "holding a lock")
    if meth in WAIT_METHODS and ("thread" in recv or "event" in recv
                                 or "future" in recv or "fut" in recv):
        return Violation(RULE, path, node.lineno,
                         f"wait .{meth}() on {recv} while holding a lock")
    return None


class _Scanner(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.lock_depth = 0
        self.violations: List[Violation] = []

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        depth, self.lock_depth = self.lock_depth, 0
        self.generic_visit(node)
        self.lock_depth = depth

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_With(self, node: ast.With) -> None:
        n_locks = sum(1 for it in node.items
                      if looks_like_lock(it.context_expr))
        self.lock_depth += n_locks
        for stmt in node.body:
            self.visit(stmt)
        self.lock_depth -= n_locks

    def visit_Call(self, node: ast.Call) -> None:
        if self.lock_depth > 0:
            v = _call_violation(node, self.path)
            if v is not None:
                self.violations.append(v)
        self.generic_visit(node)


def check_file(src: SourceFile) -> List[Violation]:
    sc = _Scanner(str(src.path))
    sc.visit(src.tree)
    return filter_suppressed(src, sc.violations)

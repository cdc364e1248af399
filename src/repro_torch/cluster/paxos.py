"""Single-decree Paxos for NodeManager primary election (§8.1).

Classic two-phase protocol over a lossy in-memory channel.  The paper uses
Paxos to guarantee at most one NM leader under concurrent elections; the
safety test drives several concurrent proposers through a dropping channel
and asserts all decided values agree.
"""
from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.analysis.runtime import make_lock


@dataclass
class Acceptor:
    node_id: int
    promised: int = -1  # guarded_by: _lock
    accepted_n: int = -1  # guarded_by: _lock
    accepted_v: Any = None  # guarded_by: _lock
    _lock: Any = field(default_factory=lambda: make_lock("Acceptor._lock"))

    def prepare(self, n: int) -> Optional[Tuple[int, Any]]:
        """Phase 1b: promise if n is the highest seen; returns prior accept."""
        with self._lock:
            if n > self.promised:
                self.promised = n
                return (self.accepted_n, self.accepted_v)
            return None

    def accept(self, n: int, v: Any) -> bool:
        """Phase 2b."""
        with self._lock:
            if n >= self.promised:
                self.promised = n
                self.accepted_n = n
                self.accepted_v = v
                return True
            return False


class LossyNetwork:
    """Message layer that drops each RPC with probability `drop`."""

    def __init__(self, drop: float = 0.0, seed: int = 0):
        self.drop = drop
        self.rng = random.Random(seed)

    def call(self, fn, *args):
        if self.rng.random() < self.drop:
            return None  # lost request or lost reply — indistinguishable
        return fn(*args)


class Proposer:
    def __init__(self, node_id: int, acceptors: List[Acceptor], net: LossyNetwork,
                 n_nodes: int):
        self.node_id = node_id
        self.acceptors = acceptors
        self.net = net
        self.n_nodes = n_nodes
        self._round = 0

    def _next_n(self) -> int:
        self._round += 1
        return self._round * self.n_nodes + self.node_id  # unique, increasing

    def propose(self, value: Any, max_rounds: int = 50) -> Optional[Any]:
        """Drive rounds until a value is chosen (may be another proposer's)."""
        majority = len(self.acceptors) // 2 + 1
        for _ in range(max_rounds):
            n = self._next_n()
            # Phase 1
            promises = []
            for a in self.acceptors:
                r = self.net.call(a.prepare, n)
                if r is not None:
                    promises.append(r)
            if len(promises) < majority:
                continue
            # adopt the highest-numbered accepted value, if any
            prior = max(promises, key=lambda p: p[0])
            v = prior[1] if prior[0] >= 0 else value
            # Phase 2
            acks = sum(
                1 for a in self.acceptors if self.net.call(a.accept, n, v)
            )
            if acks >= majority:
                return v
        return None


def elect_primary(node_ids: List[int], *, drop: float = 0.0, seed: int = 0,
                  concurrent: bool = True) -> List[Any]:
    """Run an election among node_ids; every node proposes itself.
    Returns the list of decided values (one per successful proposer)."""
    acceptors = [Acceptor(i) for i in node_ids]
    net = LossyNetwork(drop=drop, seed=seed)
    decided: List[Any] = []
    lock = threading.Lock()

    def run(nid: int):
        p = Proposer(nid, acceptors, net, n_nodes=len(node_ids))
        v = p.propose(nid)
        if v is not None:
            with lock:
                decided.append(v)

    if concurrent:
        ts = [threading.Thread(target=run, args=(i,)) for i in node_ids]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    else:
        for i in node_ids:
            run(i)
    return decided

"""Static lock-order checker.

Extracts every nested ``with <lock>`` acquisition and builds a global
acquisition graph whose nodes are *lock classes* — ``ClassName.attr``
when the receiver's class is known (``self``/``cls`` inside a class
body, or a parameter with a string/Name annotation), else ``*.attr``.
An edge A -> B means "some code path acquires A and then B while still
holding A".  A cycle in this graph is a potential deadlock: two threads
running the cyclic paths in opposite orders can each hold one lock and
wait forever on the other.

A self-edge (``C.lock -> C.lock``) is reported too: acquiring the same
lock attribute on two *different instances* of one class without a
canonical order is the classic symmetric-deadlock shape
(``a.absorb(b)`` racing ``b.absorb(a)``).  Code that orders the
instances deterministically (e.g. by ``id()``) must carry an
``# analysis: ignore[lock-order]`` suppression explaining so — the AST
cannot prove ordering.

Rule name: ``lock-order``.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.common import (SourceFile, Violation, filter_suppressed,
                                   looks_like_lock)

RULE = "lock-order"


@dataclasses.dataclass
class LockNode:
    name: str          # canonical "Class.attr" or "*.attr" or bare name
    line: int          # first acquisition site (for reporting)
    path: str


class _FnScanner(ast.NodeVisitor):
    """Collects (outer, inner) acquisition pairs inside one function."""

    def __init__(self, checker: "LockOrderChecker", cls: Optional[str],
                 fn: ast.AST, path: str):
        self.checker = checker
        self.cls = cls
        self.path = path
        self.param_types: Dict[str, str] = {}
        args = getattr(fn, "args", None)
        if args is not None:
            for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
                t = self._annotation_name(a.annotation)
                if t:
                    self.param_types[a.arg] = t
        self.held: List[str] = []

    @staticmethod
    def _annotation_name(ann: Optional[ast.AST]) -> str:
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            return ann.value.strip().strip('"')
        if isinstance(ann, ast.Name):
            return ann.id
        if isinstance(ann, ast.Attribute):
            return ann.attr
        return ""

    def _canonical(self, dotted: str) -> str:
        """'self._lock' -> 'Cls._lock'; 'other._lock' with other: NM ->
        'NM._lock'; unresolved receiver -> '*._lock'; bare 'lock' -> local."""
        parts = dotted.split(".")
        if len(parts) == 1:
            # a local lock variable: scope it to the file to avoid accidental
            # unification across modules
            return f"<local:{self.path}>.{parts[0]}"
        recv, attr = parts[0], parts[-1]
        if recv in ("self", "cls") and self.cls:
            return f"{self.cls}.{attr}"
        t = self.param_types.get(recv)
        if t:
            return f"{t}.{attr}"
        return f"*.{attr}"

    # Do not descend into nested function definitions: their bodies run on
    # their own call stacks (often other threads) and must be scanned with
    # an empty held-set, which the class-level scanner already does.
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        pass

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass

    def visit_With(self, node: ast.With) -> None:
        acquired: List[str] = []
        for item in node.items:
            dotted = looks_like_lock(item.context_expr)
            if dotted:
                canon = self._canonical(dotted)
                for outer in self.held + acquired:
                    self.checker.add_edge(outer, canon, self.path,
                                          node.lineno)
                acquired.append(canon)
                self.checker.note_node(canon, self.path, node.lineno)
        self.held.extend(acquired)
        for stmt in node.body:
            self.visit(stmt)
        if acquired:
            del self.held[-len(acquired):]


class LockOrderChecker:
    def __init__(self) -> None:
        # edge -> first (path, line) that witnessed it
        self.edges: Dict[Tuple[str, str], Tuple[str, int]] = {}
        self.nodes: Dict[str, Tuple[str, int]] = {}

    def note_node(self, name: str, path: str, line: int) -> None:
        self.nodes.setdefault(name, (path, line))

    def add_edge(self, outer: str, inner: str, path: str, line: int) -> None:
        self.edges.setdefault((outer, inner), (path, line))

    def scan(self, src: SourceFile) -> None:
        path = str(src.path)

        def walk(body, cls: Optional[str]) -> None:
            for node in body:
                if isinstance(node, ast.ClassDef):
                    walk(node.body, node.name)
                elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    sc = _FnScanner(self, cls, node, path)
                    for stmt in node.body:
                        sc.visit(stmt)
                    # nested defs get their own empty-held scan
                    for inner in ast.walk(node):
                        if inner is not node and isinstance(
                                inner, (ast.FunctionDef, ast.AsyncFunctionDef)):
                            sc2 = _FnScanner(self, cls, inner, path)
                            for stmt in inner.body:
                                sc2.visit(stmt)

        walk(src.tree.body, None)

    # ------------------------------------------------------------- cycles
    def find_cycles(self) -> List[List[str]]:
        graph: Dict[str, Set[str]] = {}
        for (a, b) in self.edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        cycles: List[List[str]] = []
        seen_cycles: Set[Tuple[str, ...]] = set()

        # self-edges first
        for (a, b) in self.edges:
            if a == b:
                key = (a,)
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    cycles.append([a, a])

        color: Dict[str, int] = {}
        stack: List[str] = []

        def dfs(u: str) -> None:
            color[u] = 1
            stack.append(u)
            for v in graph.get(u, ()):
                if v == u:
                    continue
                if color.get(v, 0) == 0:
                    dfs(v)
                elif color.get(v) == 1:
                    i = stack.index(v)
                    cyc = stack[i:] + [v]
                    key = tuple(sorted(set(cyc)))
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        cycles.append(cyc)
            stack.pop()
            color[u] = 2

        for n in sorted(graph):
            if color.get(n, 0) == 0:
                dfs(n)
        return cycles

    def violations(self) -> List[Violation]:
        out: List[Violation] = []
        for cyc in self.find_cycles():
            # report at the site of the edge closing the cycle
            a, b = cyc[-2], cyc[-1]
            path, line = self.edges.get((a, b), ("<graph>", 0))
            out.append(Violation(
                RULE, path, line,
                "lock acquisition cycle: " + " -> ".join(cyc)))
        return out


def check_files(srcs: List[SourceFile]) -> List[Violation]:
    """Build ONE global graph across all files, then per-file suppression."""
    checker = LockOrderChecker()
    for src in srcs:
        checker.scan(src)
    by_path = {str(s.path): s for s in srcs}
    out: List[Violation] = []
    for v in checker.violations():
        src = by_path.get(v.path)
        if src is not None:
            kept = filter_suppressed(src, [v])
            out.extend(kept)
        else:
            out.append(v)
    return out

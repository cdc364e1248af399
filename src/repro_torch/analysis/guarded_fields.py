"""Guarded-field checker.

Shared mutable attributes are annotated where they are initialised::

    class JoinTable:
        def __init__(self):
            self._lock = make_lock("JoinTable._lock")
            self._pending = {}   # guarded_by: _lock

Every ``self.<field>`` load/store/del in any other method must then sit
lexically inside ``with self.<lock>:``.  Two conventions exempt code
that is correct by construction:

* ``__init__`` — the object is not yet shared;
* methods whose name ends in ``_locked`` — the caller holds the lock
  (the repo-wide suffix convention, e.g. ``_sweep_locked``).

Accesses through any other receiver (``other._pending``) are flagged
too when the receiver's annotated class is known from a parameter
annotation — but the guard must then be *that object's* lock, which the
checker cannot see being held, so such access is reported unless
suppressed.  In practice cross-instance access goes through methods.

Rule name: ``guarded-field``.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.common import (SourceFile, Violation, attr_chain,
                                   filter_suppressed, looks_like_lock)

RULE = "guarded-field"
GUARDED_RE = re.compile(r"#\s*guarded_by:\s*([A-Za-z_][A-Za-z0-9_]*)")


def _collect_annotations(src: SourceFile,
                         cls: ast.ClassDef) -> Dict[str, str]:
    """field -> lock attr, from `# guarded_by:` comments on `self.f = ...`
    lines anywhere in the class body (typically __init__)."""
    out: Dict[str, str] = {}
    for node in ast.walk(cls):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for t in targets:
            name = None
            if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                name = t.attr            # self.field = ...  (in __init__)
            elif isinstance(t, ast.Name) and node in cls.body:
                name = t.id              # dataclass-style class-body field
            if name is not None:
                m = GUARDED_RE.search(src.lines[node.lineno - 1])
                if m:
                    out[name] = m.group(1)
    return out


class _MethodScanner(ast.NodeVisitor):
    def __init__(self, fields: Dict[str, str], path: str):
        self.fields = fields
        self.path = path
        self.held: Set[str] = set()        # lock attrs held via `with self.X:`
        self.violations: List[Violation] = []

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass  # nested defs run on their own stack; scanned separately

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        pass

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass

    def visit_With(self, node: ast.With) -> None:
        acquired: List[str] = []
        for item in node.items:
            dotted = looks_like_lock(item.context_expr)
            if dotted.startswith("self."):
                attr = dotted.split(".", 1)[1]
                if attr not in self.held:
                    acquired.append(attr)
            # also visit the context expr itself (e.g. self._lock is a field?)
        self.held.update(acquired)
        for item in node.items:
            self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        for stmt in node.body:
            self.visit(stmt)
        self.held.difference_update(acquired)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (isinstance(node.value, ast.Name) and node.value.id == "self"
                and node.attr in self.fields):
            lock = self.fields[node.attr]
            if lock not in self.held:
                kind = {ast.Load: "read", ast.Store: "write",
                        ast.Del: "del"}.get(type(node.ctx), "access")
                self.violations.append(Violation(
                    RULE, self.path, node.lineno,
                    f"{kind} of self.{node.attr} (guarded_by: {lock}) "
                    f"outside `with self.{lock}:`"))
        self.generic_visit(node)


def check_file(src: SourceFile) -> List[Violation]:
    out: List[Violation] = []
    path = str(src.path)
    for cls in [n for n in ast.walk(src.tree) if isinstance(n, ast.ClassDef)]:
        fields = _collect_annotations(src, cls)
        if not fields:
            continue
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name == "__init__" or fn.name.endswith("_locked"):
                continue
            defs: List[Tuple[ast.AST, bool]] = [(fn, True)]
            for inner in ast.walk(fn):
                if inner is not fn and isinstance(
                        inner, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    defs.append((inner, False))
            for d, _top in defs:
                sc = _MethodScanner(fields, path)
                for stmt in d.body:
                    sc.visit(stmt)
                out.extend(sc.violations)
    return filter_suppressed(src, out)

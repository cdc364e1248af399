"""Shared plumbing for the static passes: the Violation record, source
loading, and the inline suppression convention.

A violation on line N is suppressed when line N (or the line directly
above it, for multi-line statements) carries a comment of the form::

    # analysis: ignore[rule-name]  -- why this is a false positive

The rule name must match exactly; a bare ``# analysis: ignore`` without
a rule list suppresses nothing (we want every suppression auditable).
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
from typing import Iterable, List, Sequence

SUPPRESS_RE = re.compile(r"#\s*analysis:\s*ignore\[([a-z0-9_,\- ]+)\]")


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str           # e.g. "lock-order", "guarded-field"
    path: str           # repo-relative or absolute path of the offending file
    line: int           # 1-based line number
    msg: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.msg}"


@dataclasses.dataclass
class SourceFile:
    path: pathlib.Path
    text: str
    lines: List[str]
    tree: ast.Module

    @classmethod
    def load(cls, path: pathlib.Path) -> "SourceFile":
        text = path.read_text()
        return cls(path=path, text=text, lines=text.splitlines(),
                   tree=ast.parse(text, filename=str(path)))

    def suppressed_rules(self, line: int) -> set:
        """Rules suppressed at ``line`` (checks the line and the one above)."""
        out: set = set()
        for ln in (line, line - 1):
            if 1 <= ln <= len(self.lines):
                m = SUPPRESS_RE.search(self.lines[ln - 1])
                if m:
                    out |= {r.strip() for r in m.group(1).split(",")}
        return out

    def count_suppressions(self) -> int:
        return sum(1 for ln in self.lines if SUPPRESS_RE.search(ln))


def filter_suppressed(src: SourceFile,
                      violations: Iterable[Violation]) -> List[Violation]:
    return [v for v in violations if v.rule not in src.suppressed_rules(v.line)]


def format_report(violations: Sequence[Violation]) -> str:
    if not violations:
        return "analysis: clean (0 violations)"
    lines = [str(v) for v in violations]
    lines.append(f"analysis: {len(violations)} violation(s)")
    return "\n".join(lines)


def iter_py_files(paths: Sequence[pathlib.Path]) -> List[pathlib.Path]:
    out: List[pathlib.Path] = []
    for p in paths:
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            out.append(p)
    return out


# ---------------------------------------------------------------- AST helpers
def attr_chain(node: ast.AST) -> str:
    """Dotted-name text of a Name/Attribute chain ('self._lock',
    'other.fabric.stats_lock'); '' for anything unresolvable."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif isinstance(node, ast.Call):
        # e.g. self.region(x).atomic_lock -> keep the tail attrs only
        parts.append("<call>")
    else:
        return ""
    return ".".join(reversed(parts))


def looks_like_lock(expr: ast.AST) -> str:
    """If ``expr`` (a with-item context manager) is a lock acquisition,
    return its dotted name; else ''.  Heuristic: any Name/Attribute chain
    whose final component contains 'lock' (``self._lock``, ``elect_lock``,
    ``region.atomic_lock``...).  Calls like ``lock.acquire()`` are not
    with-items in this codebase, so plain chains suffice."""
    name = attr_chain(expr)
    if not name:
        return ""
    tail = name.rsplit(".", 1)[-1].lower()
    return name if "lock" in tail else ""

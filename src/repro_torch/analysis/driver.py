"""Orchestrates the four static passes over a set of files/dirs."""
from __future__ import annotations

import pathlib
from typing import List, Sequence

from repro_torch.analysis import blocking_lint, guarded_fields, jit_purity, lock_order
from repro_torch.analysis.common import SourceFile, Violation, iter_py_files

ALL_RULES = (lock_order.RULE, guarded_fields.RULE, blocking_lint.RULE,
             jit_purity.RULE)


def run_all(paths: Sequence[pathlib.Path | str],
            rules: Sequence[str] = ALL_RULES) -> List[Violation]:
    files = iter_py_files([pathlib.Path(p) for p in paths])
    srcs: List[SourceFile] = []
    for f in files:
        try:
            srcs.append(SourceFile.load(f))
        except SyntaxError as e:  # pragma: no cover - analysis input error
            return [Violation("parse", str(f), e.lineno or 0, str(e.msg))]
    out: List[Violation] = []
    if lock_order.RULE in rules:
        out.extend(lock_order.check_files(srcs))
    for src in srcs:
        if guarded_fields.RULE in rules:
            out.extend(guarded_fields.check_file(src))
        if blocking_lint.RULE in rules:
            out.extend(blocking_lint.check_file(src))
        if jit_purity.RULE in rules:
            out.extend(jit_purity.check_file(src))
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))


def count_suppressions(paths: Sequence[pathlib.Path | str]) -> dict:
    """path -> number of `# analysis: ignore[...]` comments (CI gate:
    certain files must stay suppression-free)."""
    out = {}
    for f in iter_py_files([pathlib.Path(p) for p in paths]):
        n = SourceFile.load(f).count_suppressions()
        if n:
            out[str(f)] = n
    return out

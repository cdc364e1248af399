"""CLI: ``python -m repro_torch.analysis [paths...]``.

Exits 1 on any violation.  ``--forbid-suppressions FILE`` (repeatable)
additionally fails if the named file carries any ``# analysis:
ignore[...]`` comment — the CI gate that keeps the hot data-plane files
(ring_buffer.py, transport.py) honest rather than annotated-around.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

from repro_torch.analysis.common import format_report
from repro_torch.analysis.driver import ALL_RULES, count_suppressions, run_all


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.analysis")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to scan (default: src/repro_torch)")
    ap.add_argument("--rules", default=",".join(ALL_RULES),
                    help="comma-separated rule subset")
    ap.add_argument("--forbid-suppressions", action="append", default=[],
                    metavar="FILE",
                    help="fail if FILE contains any analysis suppression")
    args = ap.parse_args(argv)

    paths = [pathlib.Path(p) for p in (args.paths or ["src/repro_torch"])]
    rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    violations = run_all(paths, rules)
    print(format_report(violations))

    rc = 1 if violations else 0
    if args.forbid_suppressions:
        sup = count_suppressions([pathlib.Path(f)
                                  for f in args.forbid_suppressions])
        for path, n in sorted(sup.items()):
            print(f"{path}: {n} suppression(s) in a suppression-free file")
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())

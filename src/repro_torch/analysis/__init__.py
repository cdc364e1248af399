"""Concurrency soundness toolkit.

Static AST passes (lock-order, guarded fields, blocking-while-locked,
jit purity) plus a runtime layer (InstrumentedLock + ring-protocol
checker) that observes real acquisition orders during the test suite.

Static entry point: ``python -m repro_torch.analysis [paths...]`` or
:func:`repro_torch.analysis.run_all`.  Runtime entry point: the pytest plugin
in ``tests/conftest.py`` (enabled by default, opt out with
``REPRO_LOCK_CHECK=0``).

This package deliberately has no imports from the rest of ``repro_torch`` so
the core modules can depend on :mod:`repro_torch.analysis.runtime` for their
lock factories without cycles.
"""
from __future__ import annotations

from repro_torch.analysis.common import Violation, format_report
from repro_torch.analysis.driver import run_all

__all__ = ["Violation", "format_report", "run_all"]

#!/usr/bin/env python3
"""Mutation check of flash-decode's dependency wait, on a machine with a
CUDA card.

    python3 scripts/check_decode_wait.py

The combine kernel of ``decode_attention.cu`` starts behind the split as a
programmatic dependent launch and reads the split's partials only after
``griddepcontrol.wait``.  The card test
``test_decode_combine_reads_the_partials_after_the_split_on_card`` fills
the partials with NaN before every call, so that a combine that read them
too early returns NaN, and so does ``chip_smoke.py``'s decode phase.  This
script copies the port into a temporary directory (its build goes there
too), edits the copy's kernel, and runs that test and ``chip_smoke.py
--only decode`` on each variant:

  control        the kernel as it is                        -> must pass
  no_wait        the combine's wait removed                 -> reported
  early_trigger  the split's launch_dependents at its start -> must pass
  early_no_wait  both                                        -> must fail

The split triggers its dependents only at its end, so without the wait the
combine may still start after the partials are written: ``no_wait`` is
reported as it comes out.  ``early_no_wait`` starts the combine while the
split runs, which is what the checks must catch.  Exits 0 when both
checks of every variant with an expectation meet it.
"""
from __future__ import annotations

import pathlib
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
CU = "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu"
TEST = "tests/test_torch_cuda.py::test_decode_combine_reads_the_partials_after_the_split_on_card"
WAIT = '  asm volatile("griddepcontrol.wait;" ::: "memory");  // the split\'s partials are written\n'
TRIGGER = '  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");\n'
SPLIT_START = "  constexpr bool kInt8 = std::is_same<KT, int8_t>::value;\n"

#: variant -> (remove the wait, trigger at the split's start, expected test
#: outcome: True pass, False fail, None reported)
VARIANTS = {
    "control": (False, False, True),
    "no_wait": (True, False, None),
    "early_trigger": (False, True, True),
    "early_no_wait": (True, True, False),
}


def mutate(text: str, no_wait: bool, early: bool) -> str:
    for needle in (WAIT, TRIGGER, SPLIT_START):
        if text.count(needle) != 1:
            raise SystemExit(f"check_decode_wait: {needle.strip()!r} is not in "
                             f"{CU} exactly once; update this script")
    if no_wait:
        text = text.replace(WAIT, "")
    if early:
        text = text.replace(TRIGGER, "").replace(SPLIT_START, SPLIT_START + TRIGGER)
    return text


def _last_line(proc) -> str:
    lines = [ln for ln in (proc.stdout + proc.stderr).splitlines() if ln.strip()]
    return lines[-1][-300:] if lines else ""


def run(name: str, no_wait: bool, early: bool):
    """The NaN-partials test and the smoke's decode phase on a mutated copy:
    (test passed, smoke passed).  A test that only skipped did not pass."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        for part in ("src", "tests"):
            shutil.copytree(ROOT / part, tmp / part,
                            ignore=shutil.ignore_patterns("__pycache__"))
        for part in ("pytest.ini", "chip_smoke.py"):
            shutil.copy(ROOT / part, tmp / part)
        cu = tmp / CU
        cu.write_text(mutate(cu.read_text(), no_wait, early))
        test = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                               TEST], cwd=tmp, capture_output=True, text=True)
        smoke = subprocess.run([sys.executable, "chip_smoke.py", "--only", "decode"],
                               cwd=tmp, capture_output=True, text=True)
    test_ok = test.returncode == 0 and " passed" in test.stdout
    smoke_ok = smoke.returncode == 0
    label = (f"{name}: wait {'removed' if no_wait else 'kept'}, trigger at the split's "
             f"{'start' if early else 'end'}")
    print(f"{label}: test {'passed' if test_ok else 'FAILED'} ({_last_line(test)})",
          flush=True)
    print(f"{label}: smoke decode {'passed' if smoke_ok else 'FAILED'} "
          f"({_last_line(smoke)[:200]})", flush=True)
    return test_ok, smoke_ok


def main() -> int:
    ok = True
    for name, (no_wait, early, expect) in VARIANTS.items():
        outcomes = run(name, no_wait, early)
        if expect is not None and outcomes != (expect, expect):
            print(f"{name}: expected both to {'pass' if expect else 'fail'}")
            ok = False
    print("check_decode_wait:", "every expectation met" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

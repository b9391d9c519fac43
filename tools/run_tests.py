#!/usr/bin/env python
"""Full-suite test runner: one pytest subprocess per test file.

Why not plain `pytest tests/`: XLA:CPU's in-process compiler segfaults
(rc 139) after ~100 compilations accumulate in a single process — the
crash site is below Python, inside backend_compile_and_load, and moves
with the host/compile mix, so no per-test workaround is reliable
(tests/conftest.py:subprocess_isolated documents the single worst
offender). Sharding per FILE keeps every process well under the
threshold while amortizing imports.

Usage:
    python tools/run_tests.py            # whole suite
    python tools/run_tests.py -j 2      # overlap subprocesses
    python tools/run_tests.py test_banded test_golden   # subset

Exit code 0 iff every file passes. This is the documented entry point
(README "Tests"); the driver's `python -m pytest tests/ -x -q` remains
correct for any subset small enough to stay under the compile limit.
"""

import argparse
import concurrent.futures as cf
import glob
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SUMMARY_RE = re.compile(r"(\d+) (passed|failed|error|skipped)")


def run_file(path, extra):
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", path] + extra,
        cwd=REPO, capture_output=True, text=True, timeout=3600)
    dt = time.time() - t0
    tail = (r.stdout or "") + (r.stderr or "")
    counts = dict((k, int(n)) for n, k in SUMMARY_RE.findall(tail))
    return r.returncode, dt, counts, tail


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("subset", nargs="*",
                    help="test module names (default: all tests/test_*.py)")
    ap.add_argument("-j", "--jobs", type=int,
                    default=int(os.environ.get("DOT_TEST_JOBS", "1")))
    ap.add_argument("--pytest-arg", action="append", default=[],
                    help="extra argument forwarded to each pytest child")
    args = ap.parse_args()

    if args.subset:
        files = [os.path.join(REPO, "tests", s if s.endswith(".py")
                              else s + ".py") for s in args.subset]
        missing = [f for f in files if not os.path.exists(f)]
        if missing:
            print("no such test file(s):", *missing, file=sys.stderr)
            return 2
    else:
        files = sorted(glob.glob(os.path.join(REPO, "tests", "test_*.py")))

    t0 = time.time()
    failures, total = [], {"passed": 0, "failed": 0, "error": 0,
                           "skipped": 0}
    with cf.ThreadPoolExecutor(max_workers=max(1, args.jobs)) as ex:
        futs = {ex.submit(run_file, f, args.pytest_arg): f for f in files}
        for fut in cf.as_completed(futs):
            f = futs[fut]
            name = os.path.basename(f)
            try:
                rc, dt, counts, tail = fut.result()
            except subprocess.TimeoutExpired:
                rc, dt, counts, tail = -1, 3600.0, {}, "TIMEOUT"
            for k in total:
                total[k] += counts.get(k, 0)
            status = "ok" if rc == 0 else f"FAIL rc={rc}"
            print(f"{name:<34} {status:<12} "
                  f"{counts.get('passed', 0):>3} passed  {dt:6.1f}s",
                  flush=True)
            if rc != 0:
                failures.append((name, rc, tail))

    print(f"\n{total['passed']} passed, {total['failed']} failed, "
          f"{total['error']} errors, {total['skipped']} skipped "
          f"in {time.time() - t0:.0f}s across {len(files)} files")
    for name, rc, tail in failures:
        print(f"\n===== {name} (rc {rc}) — last output =====")
        print(tail[-4000:])
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

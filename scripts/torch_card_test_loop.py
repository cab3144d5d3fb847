#!/usr/bin/env python3
"""Run a selection of the card tests many times, each run in a process of
its own, to catch a failure that shows only now and then.

    python3 scripts/torch_card_test_loop.py -k EXPR [--runs 200]
        [--parallel 8] [--out DIR]

Each run is `python -m pytest tests/test_torch_port_cuda.py --noconftest
-m cuda -q -rfE --tb=long -p no:cacheprovider -k EXPR`; up to
`--parallel` runs share the card at a time.  Every run's output is kept
in `--out` (run-NNN.txt); the last line printed is one JSON object with
the count of runs, of runs that passed, each failing run's number and the
tests that failed in it.  Exits 1 if any run failed.  Needs a CUDA device
for the tests to run (they skip without one); imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def run_once(i: int, expr: str, out: pathlib.Path) -> dict:
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests/test_torch_port_cuda.py",
         "--noconftest", "-m", "cuda", "-q", "-rfE", "--tb=long",
         "-p", "no:cacheprovider", "-k", expr],
        cwd=ROOT, capture_output=True, text=True)
    text = proc.stdout + proc.stderr
    (out / f"run-{i:03d}.txt").write_text(text)
    summary = text.strip().splitlines()[-1] if text.strip() else ""
    return {"run": i, "rc": proc.returncode,
            "passed": int(m.group(1)) if (m := re.search(r"(\d+) passed",
                                                          summary)) else 0,
            "failed": re.findall(r"^(?:FAILED|ERROR) (\S+)", text, re.M)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-k", dest="expr", required=True)
    ap.add_argument("--runs", type=int, default=200)
    ap.add_argument("--parallel", type=int, default=8)
    ap.add_argument("--out", default="build/card_test_loop")
    args = ap.parse_args()
    out = ROOT / args.out
    out.mkdir(parents=True, exist_ok=True)
    with cf.ThreadPoolExecutor(args.parallel) as pool:
        runs = list(pool.map(lambda i: run_once(i, args.expr, out),
                             range(args.runs)))
    bad = [r for r in runs if r["rc"] != 0]
    print(json.dumps({"runs": len(runs), "runs_passed": len(runs) - len(bad),
                      "tests_passed_per_run": sorted({r["passed"]
                                                      for r in runs}),
                      "failing_runs": [{"run": r["run"], "rc": r["rc"],
                                        "failed": r["failed"]} for r in bad],
                      "expr": args.expr}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The PyTorch port's CI gate: lint -> race -> audit -> cost -> the port's
tests, with a machine-readable summary (the port's ``scripts/check.py``).

    python scripts/torch_check.py [--lint-only | --tests-only]
                                  [--programs a,b] [--summary PATH]
                                  [-- extra pytest args]

runs, in order:

1. **lint**: ``python -m iwae_replication_project_tpu_torch.analysis``,
   the port's rule suite over its package (concurrency rules, the JAX-idiom
   rules read for PyTorch, the leak pass, ``useless-suppression``);
2. **race**: ``... .analysis.race --self-test``, the static
   future/span/pin leak pass plus the race detector's seeded battery;
3. **audit**: ``... .analysis.audit``, the aten-graph auditor (in-place
   writes into inputs, padding taint, host transfers, recompile
   cardinality) over the port's recorded programs;
4. **cost**: ``... .analysis.audit.cost``, static peak memory, FLOPs and
   collectives of the same programs, writing the committed
   ``results/torch_cost_report.json`` (a full-suite run only);
5. **tests**: ``pytest tests/test_torch_*.py -m 'not slow and not
   cuda'``; on a machine without JAX with ``--noconftest`` (the
   repository's ``tests/conftest.py`` imports JAX), as the card's tests
   run.

Every full run writes ``results/torch_check_summary.json`` (per stage:
status, exit code, wall seconds and, for the analyzers, finding counts).
A single-stage run (``--lint-only``: stages 1-4; ``--tests-only``) skips
the default write, so a partial record never poses as the full one, but
honours an explicit ``--summary``. Analyzer exit codes are classified as
``scripts/check.py`` classifies them: 0 ``ok``, 1 ``findings``, anything
else ``internal-error`` (a crashed analyzer never passes as a findings
list). The stages do not short-circuit; the exit status is non-zero if any
stage failed.
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "iwae_replication_project_tpu_torch"
SUMMARY = os.path.join("results", "torch_check_summary.json")
COST_REPORT = os.path.join("results", "torch_cost_report.json")


def classify_analyzer_rc(rc: int) -> str:
    """An analyzer CLI's exit code as a summary status: 0 ``ok``, 1
    ``findings``, anything else ``internal-error`` (2 is the CLIs' declared
    crash code; a signal or an uncaught exception is no findings list
    either)."""
    if rc == 0:
        return "ok"
    if rc == 1:
        return "findings"
    return "internal-error"


def run_analyzer(label: str, module: str, extra_args=()) -> dict:
    """Run a findings CLI with ``--format json``, classify its exit code and
    print its findings one per line."""
    print(f"== {label} ".ljust(72, "="), flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", module, "--format", "json", *extra_args],
        cwd=REPO, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    status = classify_analyzer_rc(proc.returncode)
    counts, total = {}, None
    if status == "internal-error":
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr)
        print(f"{label}: INTERNAL ERROR (rc={proc.returncode}): the "
              f"analyzer crashed; this is NOT a findings failure")
    else:
        try:
            payload = json.loads(proc.stdout)
            counts = payload.get("counts", {})
            total = payload.get("total", 0)
            for f in payload.get("findings", []):
                where = f.get("path") or f.get("program", "?")
                line = f.get("line")
                at = f.get("location") or (f"{line}:{f.get('col', 0)}"
                                           if line is not None else "")
                print(f"{where}:{at}: [{f['rule']}] {f['message']}")
            print(f"{label}: "
                  f"{'clean' if total == 0 else f'{total} finding(s)'}")
        except (json.JSONDecodeError, KeyError, AttributeError) as e:
            status = "internal-error"
            sys.stdout.write(proc.stdout)
            sys.stderr.write(proc.stderr)
            print(f"{label}: unparseable analyzer output ({e})")
    return {"name": label, "status": status, "rc": proc.returncode,
            "wall_seconds": round(wall, 3), "findings": total,
            "counts": counts}


def run_step(label: str, cmd: List[str]) -> dict:
    print(f"== {label} ".ljust(72, "="), flush=True)
    t0 = time.perf_counter()
    rc = subprocess.call(cmd, cwd=REPO)
    return {"name": label, "status": "ok" if rc == 0 else "failed",
            "rc": rc, "wall_seconds": round(time.perf_counter() - t0, 3)}


def jax_installed() -> bool:
    return importlib.util.find_spec("jax") is not None


def test_command(extra=()) -> List[str]:
    """The port's test files, CPU profile, ``--noconftest`` where JAX is
    missing."""
    files = sorted(os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, "tests", "test_torch_*.py")))
    cmd = [sys.executable, "-m", "pytest", *files, "-q", "-m",
           "not slow and not cuda", "-p", "no:cacheprovider"]
    if not jax_installed():
        cmd.append("--noconftest")
    return cmd + list(extra)


def write_summary(path: str, summary: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(summary, f, indent=2)
        f.write("\n")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    passthrough: List[str] = []
    if "--" in argv:
        split = argv.index("--")
        argv, passthrough = argv[:split], argv[split + 1:]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lint-only", action="store_true",
                    help="the analyzers only (lint, race, audit, cost)")
    ap.add_argument("--tests-only", action="store_true")
    ap.add_argument("--programs", default=None,
                    help="a subset of the audited programs for the audit "
                         "and cost stages (the cost report is then not "
                         "written)")
    ap.add_argument("--summary", default=None,
                    help=f"where to write the stage summary (default "
                         f"{SUMMARY}; single-stage runs write none unless "
                         f"given one)")
    args = ap.parse_args(argv)

    single_stage = args.lint_only or args.tests_only
    subset = ("--programs", args.programs) if args.programs else ()
    stages = []
    if not args.tests_only:
        stages.append(run_analyzer("lint", f"{PKG}.analysis"))
        stages.append(run_analyzer("race", f"{PKG}.analysis.race",
                                   ("--self-test",)))
        stages.append(run_analyzer("audit", f"{PKG}.analysis.audit",
                                   subset))
        stages.append(run_analyzer(
            "cost", f"{PKG}.analysis.audit.cost",
            subset or ("--out", COST_REPORT)))
    if not args.lint_only:
        stages.append(run_step("tests", test_command(passthrough)))

    # gate on the status, not the exit code alone: an analyzer that exited
    # 0 with unparseable output is an internal error
    summary = {"ok": all(s["status"] == "ok" for s in stages),
               "jax_installed": jax_installed(), "stages": stages}
    path = args.summary
    if path is None and single_stage:
        print("(single-stage run: default summary not written; pass "
              "--summary <path> to record it)")
    else:
        path = path or SUMMARY
        write_summary(os.path.join(REPO, path), summary)
        print(f"summary -> {path}")
    print("== torch check summary ".ljust(72, "="))
    for s in stages:
        note = "ok" if s["status"] == "ok" else \
            f"{s['status'].upper()} (rc={s['rc']})"
        extra = f", {s['findings']} finding(s)" if s.get("findings") else ""
        print(f"{s['name']:<8}: {note}  [{s['wall_seconds']:.1f}s{extra}]")
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

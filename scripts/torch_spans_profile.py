#!/usr/bin/env python3
"""One benchmark cell with the port's span recorder on from process start.

    python3 scripts/torch_spans_profile.py --record 1 -- \\
        --workload iwae2l-eval --seed 7 --seconds 30 --trace 1

Runs ``portbench/run.py`` in this process with the arguments after ``--``,
the recorder (``iwae_replication_project_tpu_torch/telemetry/spans.py``) on
from the start through the run (``--record 1``) or off (``--record 0``, as
the benchmark runs). The harness prints its own lines, its result line
included. With ``--record 1`` this script then drains the recorder and
writes to standard error the per-span table (count, host ms, self ms,
device ms, and with ``--trace 1`` the device idle of the profiled
sub-window put down to each span, ``portbench/harness/spans.py``), the
largest idle gap and its span; its last line on standard output is one JSON
object: the harness's result line's metrics, the recorder's counters and
dropped spans, each pass's device ms, and the four span readings
(``pass_device_ms``, ``capture_ms``, ``chunk_issue_ms``,
``host_idle_ms``; null where the cell has none), with the sub-window's
idle put down to spans and its total.

Compare ``--record 1`` with ``--record 0`` on the same seeds and
``--trace 0`` for the recorder's cost to the window's rate. ``--dry
'{"traffic": {...}}'`` runs the cell on the CPU at those traffic overrides
(a rehearsal: no device trace, no device times).
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from iwae_replication_project_tpu_torch.telemetry import spans  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", type=int, choices=(0, 1), default=1)
    ap.add_argument("--dry", type=json.loads, default=None)
    ap.add_argument("run_args", nargs=argparse.REMAINDER,
                    help="after --: portbench/run.py's arguments")
    args = ap.parse_args(argv)
    run_args = [a for a in args.run_args if a != "--"]
    if args.record:
        spans.start()
    from portbench.harness import spans as readings
    from portbench.harness import trace as trace_mod

    kept = []
    record = trace_mod.record

    def keep(fn):
        kept.append(record(fn))
        return kept[-1]
    trace_mod.record = keep
    spec = importlib.util.spec_from_file_location(
        "portbench_run", ROOT / "portbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = run.main(run_args, dry=args.dry)
    lines = out.getvalue().splitlines()
    print("\n".join(lines), flush=True)
    spans.stop()
    if not args.record or code != 0:
        return code
    d = spans.drain()
    recs = d.records
    tr = kept[-1] if kept else None
    gaps = readings.idle_gaps(tr, recs) if tr is not None else []
    idle = {}
    for label, ns in gaps:
        idle[label] = idle.get(label, 0) + ns
    print("\n".join(readings.table(recs, idle)), file=sys.stderr)
    result = {"metrics": json.loads(lines[-1])["metrics"] if lines else {},
              "counts": d.counts, "dropped": d.dropped,
              "pass_device_ms_each": [round(r.device_ms, 3) for r in
                                      d.named("train/pass")],
              "readings": {"pass_device_ms": readings.pass_device_ms(recs),
                           "capture_ms": readings.capture_ms(recs),
                           "chunk_issue_ms": readings.chunk_issue_ms(recs)}}
    if tr is not None and not tr.empty:
        chunks = sum(1 for r in recs if r.name == "eval/chunk"
                     and tr.t0 <= r.t_start_ns <= tr.t1)
        result["readings"]["host_idle_ms"] = readings.host_idle_ms(
            tr, recs, chunks)
        label, ns = max(gaps, key=lambda g: g[1])
        print(f"largest idle gap: {ns / 1e3:.1f} us, {label}",
              file=sys.stderr)
        result["sub_window"] = {
            "idle_ns": tr.window_ns - tr.busy_ns,
            "idle_by_span_ns": idle, "chunks": chunks,
            "largest_gap": [label, ns]}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Dump a serving tier's flight recorder (port of ``telemetry/trace_cli.py``,
JAX's ``iwae-trace``).

A pure socket client (no device): connects to a running tier of either
package (the wire is the same), issues the ``traces`` control op
(serving/frontend/protocol.py) and writes the result as Chrome trace-event
JSON (load the file in ``chrome://tracing`` or Perfetto) or as the raw
trace documents::

    python -m iwae_replication_project_tpu_torch.telemetry.trace_cli \\
        127.0.0.1:7777 --out traces.json          # chrome format
    ... 127.0.0.1:7777 --raw --limit 8            # raw docs, stdout
    ... 127.0.0.1:7777 --stats                    # recorder accounting
    ... 127.0.0.1:7777 --trace-id ab12...         # one trace by id

The same data is served over HTTP at ``/traces`` when the tier runs with
``--metrics-port``. ``--json`` wraps the output in the shared
observability-CLI envelope; this module keeps its own copy of
:func:`make_envelope` (JAX ``analysis/regress.py``).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Sequence

#: version of the shared ``--json`` CLI envelope
ENVELOPE_SCHEMA = 1


def make_envelope(tool: str, mode: str, *, ok: bool,
                  findings: Sequence[dict] = (), data=None) -> dict:
    """The ``--json`` output convention of the observability CLIs: tool
    name, envelope schema version, the mode that ran, an overall ok bit,
    typed findings and the tool's payload."""
    return {"tool": str(tool), "schema": ENVELOPE_SCHEMA,
            "mode": str(mode), "ok": bool(ok),
            "findings": list(findings), "data": data}


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m iwae_replication_project_tpu_torch.telemetry."
             "trace_cli",
        description="dump a serving tier's tail-sampled request traces "
                    "as Chrome trace-event JSON")
    ap.add_argument("target", metavar="HOST:PORT",
                    help="a running serving tier's TCP endpoint")
    ap.add_argument("--out", type=str, default=None,
                    help="write here instead of stdout")
    ap.add_argument("--raw", action="store_true",
                    help="raw flight-recorder trace documents (+ stats) "
                         "instead of Chrome trace-event JSON")
    ap.add_argument("--stats", action="store_true",
                    help="recorder accounting only (kept/dropped/ring "
                         "occupancy), no trace bodies")
    ap.add_argument("--limit", type=int, default=None,
                    help="most recent N traces only")
    ap.add_argument("--trace-id", dest="trace_id", type=str, default=None,
                    help="one trace by id (e.g. from a latency exemplar)")
    ap.add_argument("--json", action="store_true",
                    help="wrap the output in the shared observability-CLI "
                         "envelope (tool/schema/mode/ok/findings/data)")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from iwae_replication_project_tpu_torch.serving.frontend.client import (
        TierClient, TierError)

    host, _, port = args.target.rpartition(":")
    try:
        cli = TierClient(host or "127.0.0.1", int(port))
    except (OSError, ValueError) as e:
        print(f"trace_cli: cannot reach tier at {args.target!r}: {e}",
              file=sys.stderr)
        return 2
    try:
        if args.stats:
            doc = cli.traces(limit=0)["stats"]
        else:
            doc = cli.traces(limit=args.limit, trace_id=args.trace_id,
                             fmt=None if args.raw else "chrome")
    except (TierError, OSError) as e:
        print(f"trace_cli: tier rejected the traces op: {e}",
              file=sys.stderr)
        return 2
    finally:
        cli.close()
    n = len(doc.get("traceEvents", doc.get("traces", []))) \
        if isinstance(doc, dict) else 0
    if args.json:
        mode = ("stats" if args.stats
                else "raw" if args.raw else "chrome")
        doc = make_envelope("iwae-trace", mode, ok=True, data=doc)
    text = json.dumps(doc, indent=2)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
        print(f"trace_cli: wrote {args.out} ({n} "
              f"{'events' if not args.raw else 'traces'})")
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

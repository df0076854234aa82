"""Audit CLI: ``python -m iwae_replication_project_tpu_torch.analysis.audit``
(port of ``analysis/audit/cli.py``).

Exit codes match the lint CLI's and are load-bearing for
``scripts/torch_check.py``: **0** = every pass clean on every program,
**1** = findings, **2** = internal/usage error (the analyzer itself failed;
the gate reports it as a crash, never as findings). ``--format json``
emits one object (findings, per-rule counts, each audited program's
signature and its inputs' shape, dtype and device); the default human
format is one finding per line, then the per-program table and a tally.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback
from collections import Counter
from typing import List, Optional

from iwae_replication_project_tpu_torch.analysis.audit import core
from iwae_replication_project_tpu_torch.analysis.audit.graphs import (
    input_metas,
    signature,
)
from iwae_replication_project_tpu_torch.analysis.audit.programs import (
    PROGRAM_NAMES,
    build_programs,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m iwae_replication_project_tpu_torch.analysis.audit",
        description="Aten-graph program auditor: in-place writes into "
                    "inputs, padding taint, host transfers and recompile "
                    "cardinality over the port's real recorded programs.")
    p.add_argument("--format", choices=("human", "json"), default="human")
    p.add_argument("--list-passes", action="store_true",
                   help="print the registered passes and exit")
    p.add_argument("--select", default=None,
                   help="comma-separated pass names to run (only these)")
    p.add_argument("--programs", default=None,
                   help=f"comma-separated subset of the audited programs "
                        f"(default: all of {', '.join(PROGRAM_NAMES)})")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.list_passes:
            passes = core.all_passes()
            width = max(len(n) for n in passes)
            for name in sorted(passes):
                print(f"{name:<{width}}  {passes[name].summary}")
            return 0
        passes = core.select_passes(
            [s.strip() for s in args.select.split(",") if s.strip()]
            if args.select else None)
        include = [s.strip() for s in args.programs.split(",") if s.strip()] \
            if args.programs else None
        programs = build_programs(include)
        env = core.AuditEnv.current(include_store=True)
        findings = core.run_audit(programs, passes, env)
    except (ValueError, FileNotFoundError) as e:
        print(f"iwae-audit: error: {e}", file=sys.stderr)
        return 2
    except Exception:
        print("iwae-audit: internal error:", file=sys.stderr)
        traceback.print_exc()
        return 2

    counts = dict(Counter(f.rule for f in findings))
    if args.format == "json":
        print(json.dumps({
            "findings": [f.to_dict() for f in findings],
            "counts": counts,
            "total": len(findings),
            "passes": sorted(passes),
            "programs": {p.name: ({**signature(p.graph),
                                   "inputs": input_metas(p.graph)}
                                  if p.graph is not None
                                  else {"error": p.error})
                         for p in programs},
            "env": {"device": env.device},
        }, indent=2))
    else:
        for f in findings:
            print(f.human())
        print(f"audited {len(programs)} program(s) with "
              f"{len(passes)} pass(es) for device={env.device}")
        for p in programs:
            if p.graph is None:
                print(f"  {p.name:<24} not recorded: {p.error}")
                continue
            sig = signature(p.graph)
            kernels = ", ".join(f"{k} x{n}" for k, n in
                                sig["kernels"].items())
            print(f"  {p.name:<24} {sig['node_count']:>5} ops, "
                  f"{len(sig['ops'])} distinct"
                  + (f", {len(p.taints)} padded input(s)" if p.taints
                     else "")
                  + (f"; kernels {kernels}" if kernels else ""))
        if findings:
            tally = ", ".join(f"{rule}: {n}"
                              for rule, n in sorted(counts.items()))
            print(f"\n{len(findings)} finding(s) ({tally})")
        else:
            print("iwae-audit: clean")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())

"""Lint CLI: ``python -m iwae_replication_project_tpu_torch.analysis [paths]``
(the port's ``iwae-lint``).

Exit codes: 0 = clean, 1 = findings, 2 = usage/config error. ``--format
json`` emits one machine-readable object (findings + counts); the default
human format is one ``path:line:col: [rule] message`` per line, with a
per-rule tally. Paths default to the config's ``paths`` (the port's
package).
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from typing import List, Optional

from iwae_replication_project_tpu_torch.analysis import core
from iwae_replication_project_tpu_torch.analysis.config import LintConfig, load_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m iwae_replication_project_tpu_torch.analysis",
        description="the port's lint suite: lock order, unlocked shared "
                    "state, blocking calls under a lock, swallowed "
                    "exceptions, and the future/span/pin leak pass.")
    p.add_argument("paths", nargs="*",
                   help="files/directories to lint (default: the "
                        "config's paths)")
    p.add_argument("--format", choices=("human", "json"), default="human")
    p.add_argument("--list-rules", action="store_true",
                   help="print the registered rules and exit")
    p.add_argument("--select", default=None,
                   help="comma-separated rule names to run (only these)")
    p.add_argument("--ignore", default=None,
                   help="comma-separated rule names to skip")
    p.add_argument("--no-config", action="store_true",
                   help="ignore [tool.iwaelint_torch]; built-in defaults "
                        "only")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.no_config:
            config, src = LintConfig(), None
        else:
            config, src = load_config()
        if args.select:
            config.select = [s.strip() for s in args.select.split(",")
                             if s.strip()]
        if args.ignore:
            config.disable = list(config.disable) + [
                s.strip() for s in args.ignore.split(",") if s.strip()]

        if args.list_rules:
            rules = core.all_rules()
            width = max(len(n) for n in rules)
            for name in sorted(rules):
                print(f"{name:<{width}}  {rules[name].summary}")
            print(f"{core.BARE_SUPPRESSION:<{width}}  (meta) suppression "
                  f"comment lacks a '-- justification' tail")
            print(f"{core.USELESS_SUPPRESSION:<{width}}  (meta) suppressed "
                  f"rule does not fire at the suppression's scope")
            return 0

        paths = args.paths or config.paths
        findings = core.lint_paths(paths, config)
    except (ValueError, FileNotFoundError) as e:
        print(f"iwaelint: error: {e}", file=sys.stderr)
        return 2

    if args.format == "json":
        print(json.dumps({
            "findings": [f.to_dict() for f in findings],
            "counts": dict(Counter(f.rule for f in findings)),
            "total": len(findings),
            "config": src,
        }, indent=2))
    else:
        for f in findings:
            print(f.human())
        if findings:
            tally = ", ".join(f"{rule}: {n}" for rule, n in
                              sorted(Counter(f.rule for f in findings).items()))
            print(f"\n{len(findings)} finding(s) ({tally})")
        else:
            print("iwaelint: clean")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. The cell (``workloads`` of ``BENCHMARK.json``) names a configuration
and a traffic mix; the mix's ``kind`` names the general runner under
``harness/``. The run loads, warms every shape it uses, measures for
``--seconds`` and prints one JSON line last: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a profiled sub-window after the window. Without CUDA, or with fewer
cards than the cell asks for, it prints no result and exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import manifest  # noqa: E402
from portbench.harness.cell import NO_CARD, Cell  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def make_cell(args, dry: Optional[dict] = None) -> Cell:
    m = manifest.load()
    wl = manifest.by_name(m["workloads"], args.workload, "workload")
    traffic = manifest.traffic(wl["traffic"])
    if dry is not None:
        traffic.update(dry.get("traffic", {}))
    return Cell(workload=wl["name"], seed=args.seed, seconds=args.seconds,
                trace=bool(args.trace),
                config=manifest.config(m, wl["config"]), traffic=traffic,
                chips=wl["chips"], metrics=manifest.cell_metrics(m, wl["name"]),
                limits=manifest.limits(wl["name"]), t_start=T_START, dry=dry)


def main(argv=None, dry: Optional[dict] = None) -> int:
    """Run a cell; `dry` (tests only) runs it on the CPU with the traffic
    overrides and the fault it names, without looking for a card."""
    args = parse(argv)
    cell = make_cell(args, dry)
    if dry is None:
        import torch
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            print(f"no result: the cell needs {cell.chips} CUDA cards, "
                  f"this machine has {have}", file=sys.stderr)
            return NO_CARD
    cell.phase("imports and card")
    runner = importlib.import_module(
        f"portbench.harness.{cell.traffic['kind']}")
    return runner.run(cell)


if __name__ == "__main__":
    sys.exit(main())

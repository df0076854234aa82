"""``BENCHMARK.json`` and the files the harness finds by the names in it.

* a configuration: the ``file`` of its entry under ``configs``;
* a traffic mix: ``portbench/traffic/<traffic>.json``, the parameters the
  general runner of its ``kind`` reads (``harness/train_pass.py``,
  ``harness/eval_nll.py``);
* a per-layer metric: ``portbench/metrics/<metric>.py``, its reader;
* a kernel's work counts: ``portbench/kernels/<kernel>.py``;
* a cell's limits for the comparison that decides ``correct``:
  ``portbench/checks/<workload>.json``.

A later change adds a configuration, a mix, a metric or a cell by adding
files and entries; none of these needs an edit here.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str) -> dict:
    entry = by_name(manifest["configs"], name, "configuration")
    return json.loads((ROOT / entry["file"]).read_text())


def traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def limits(workload: str) -> Dict[str, float]:
    return json.loads((BENCH / "checks" / f"{workload}.json").read_text())


def _module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str) -> ModuleType:
    return _module(BENCH / "metrics" / f"{name}.py")


def kernel(name: str) -> ModuleType:
    return _module(BENCH / "kernels" / f"{name}.py")


def cell_metrics(manifest: dict, workload: str) -> Dict[str, List[dict]]:
    """The end-to-end and per-layer metrics the cell reports: those that
    list it under ``workloads``, and those without the key; a per-layer
    metric without it goes with every cell of its ``moves``."""
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if workload in m.get("workloads", [workload])
             and m["moves"] in names]
    return {"end_to_end": e2e, "per_layer": layer}

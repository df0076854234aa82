"""One run of one cell: its settings, the card it runs on, and the result
line it prints.

The result is one JSON object on the last line of standard output, with
``correct``, ``attempted``, ``failed``, ``metrics`` and ``device`` (and,
traced, ``breakdown``), and last ``checks``: each number the comparison
with the reference computed, beside its limit. The same numbers are the
last lines of standard error. A run that finds ``jax``, ``jaxlib``,
``flax`` or the JAX package among the loaded modules (compared by whole
top-level names: the port's own name begins with the JAX package's)
prints no result and exits 4.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

#: top-level module names no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "iwae_replication_project_tpu")

#: exit codes: no card (or too few), JAX loaded
NO_CARD, JAX_LOADED = 3, 4


@dataclasses.dataclass
class Cell:
    workload: str
    seed: int
    seconds: float
    trace: bool
    config: dict
    traffic: dict
    chips: int
    metrics: Dict[str, List[dict]]
    limits: Dict[str, float]
    #: ``time.perf_counter()`` when the process started
    t_start: float
    #: a test's run on the CPU (``run.main(dry=...)``): its traffic
    #: overrides and an optional ``"patch": "module:function"`` that
    #: breaks the program underneath; None on the card
    dry: Optional[dict] = None
    #: ``(name, seconds since the start)`` at the end of each set-up phase
    phases: List[Tuple[str, float]] = dataclasses.field(default_factory=list)

    def phase(self, name: str) -> None:
        self.phases.append((name, time.perf_counter() - self.t_start))

    @property
    def device_type(self) -> str:
        return "cpu" if self.dry is not None else "cuda"


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


#: what ``nvidia-smi`` reads of each card after the window
AFTER = ("name,power.limit,clocks.sm,clocks.mem,power.draw,temperature.gpu,"
         "clocks_throttle_reasons.active")


def card_line(query: str = "name,power.limit") -> str:
    """What ``nvidia-smi`` reads of every card."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return "; ".join(out.stdout.strip().splitlines()) or "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def device_info(cell: Cell, peak_bytes: int) -> dict:
    if cell.dry is not None:
        return {"platform": "cpu", "kind": "cpu", "count": cell.chips,
                "memory_peak_bytes": peak_bytes}
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips, "memory_peak_bytes": peak_bytes}


def emit(cell: Cell, *, attempted: int, failed: int,
         metrics: Dict[str, Tuple[float, str]], device: dict,
         checks: Dict[str, float], breakdown: Optional[dict] = None) -> int:
    """Judge the checks against the cell's limits, print the result and
    return the exit code (0, or :data:`JAX_LOADED` with no result)."""
    found = loaded_forbidden()
    if found:
        print(f"refused: the run loaded {found}", file=sys.stderr,
              flush=True)
        return JAX_LOADED
    # the numbers the cell's limits name are compared; a number without a
    # limit (one that separates no fault from sound runs) is not
    checks = {n: checks.get(n, math.nan) for n in cell.limits}
    correct = all(math.isfinite(v) and v <= cell.limits[n]
                  for n, v in checks.items())
    # a number that is not finite fails, and is written as text: JSON has
    # no NaN
    judged = {n: {"value": v if math.isfinite(v) else str(v),
                  "limit": cell.limits[n]} for n, v in checks.items()}
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed),
            "metrics": {n: {"value": v, "unit": u}
                        for n, (v, u) in metrics.items()},
            "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = judged
    sys.stdout.flush()
    if cell.dry is None:
        print(f"card after the window: {card_line(AFTER)}", file=sys.stderr)
    if cell.phases:
        print("set-up: " + ", ".join(f"{n} at {t:.3f} s"
                                     for n, t in cell.phases),
              file=sys.stderr)
    for name, v in judged.items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

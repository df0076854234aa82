#!/usr/bin/env python3
"""Where the PyTorch port's serving time goes on the card, by torch.profiler.

    python3 scripts/torch_serving_profile.py [--out PATH.json]

Builds the ``northstar-iwae-2l-k50`` engine of the port on ``cuda`` (fresh
weights from the preset's seed), warms it, then profiles two windows with
``torch.profiler`` (CPU and CUDA activities):

* ``program``: 20 back-to-back 64-row score programs with their noise
  already on the card, i.e. the device side of one full dispatch;
* ``burst``: the pipelined engine serving a ragged burst of 325 score
  requests, as ``chip_smoke.py`` sends them.

For each window it reports the kernels launched per iteration, device time
by kernel name, the device's busy time (the union of kernel intervals) and
its busy share of the window. Prints one JSON object, and also writes it to
``--out`` when given. Needs a CUDA device; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PRESET = "northstar-iwae-2l-k50"


def _trace_stats(prof, iterations: int) -> dict:
    """Kernel counts, device time by name and busy share from the profiler's
    chrome trace (kernel events carry their device start and duration)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in timed if e.get("cat") == "kernel"]
    if not kernels:
        return {"device_time": "not measured: the trace holds no kernel "
                               "events"}
    t0 = min(e["ts"] for e in timed)
    t1 = max(e["ts"] + e["dur"] for e in timed)
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_name: dict = {}
    for e in kernels:
        rec = by_name.setdefault(e["name"], [0, 0.0])
        rec[0] += 1
        rec[1] += e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {
        "window_ms": (t1 - t0) / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_busy_share": busy / (t1 - t0),
        "kernels_per_iteration": len(kernels) / iterations,
        "device_ms_per_iteration": sum(e["dur"] for e in kernels)
        / iterations / 1e3,
        "top_kernels": [{"name": name[:80], "launches": n,
                         "device_ms": dur / 1e3}
                        for name, (n, dur) in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the JSON object to this file")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device: this profile runs on the GPU", file=sys.stderr)
        return 1
    from iwae_replication_project_tpu_torch import zoo
    from iwae_replication_project_tpu_torch.serving.programs import (
        draw_noise, score_rows)

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    eng = zoo.serving_engine(PRESET, seed=0, timeout_s=None)
    eng.warmup(ops=("score",))
    cfg, _ = eng._kernel_for("score")
    seeds = list(range(64))
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.rand(64, 784) > 0.5).astype(np.float32)).cuda()
    noise = [t.cuda() for t in draw_noise(cfg, "score", 0, seeds, eng.k)]

    def program():
        return score_rows(eng._params, cfg, 0, seeds, x, eng.k, noise=noise)

    for _ in range(3):
        program()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(20):
            program()
        torch.cuda.synchronize()
    out = {"card": smi, "preset": PRESET,
           "program": _trace_stats(prof, 20)}

    sizes = [1, 3, 7, 17, 33, 64, 2, 5]
    rows, n = [], 0
    while n < 300:
        rows.append((rng.rand(sizes[len(rows) % len(sizes)], 784) > 0.5)
                    .astype(np.float32))
        n += len(rows[-1])
    eng.start()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        futures = []
        for batch in rows:
            futures += [eng.submit("score", r) for r in batch]
            time.sleep(0.0005)
        for f in futures:
            f.result(timeout=300)
        wall = time.perf_counter() - t0
    eng.stop()
    burst = _trace_stats(prof, eng.metrics.counters()["dispatches"])
    burst["requests"] = len(futures)
    burst["wall_ms_host"] = wall * 1e3
    burst["dispatches"] = eng.metrics.counters()["dispatches"]
    out["burst"] = burst
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

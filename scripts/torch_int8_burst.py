#!/usr/bin/env python3
"""A ragged score burst through the flagship serving engine, for one
precision policy, on the card.

    python3 scripts/torch_int8_burst.py [--port-root DIR] \
        [--precision fp32|int8] [--int8 auto|force] [--bursts 3] [--out PATH]

Builds ``northstar-iwae-2l-k50`` (fresh weights from the preset's seed) as
a pipelined ``ServingEngine`` under ``--precision`` (``IWAE_SERVING_INT8``
set from ``--int8`` for int8: ``auto`` races the int8 and fp32 programs per
bucket on the card, ``force`` admits every bucket), warms its score
programs, then sends ``--bursts`` bursts of 300 score requests in groups of
1, 3, 7, 17, 33, 64, 2 and 5 rows with 0.5 ms between groups, as
``chip_smoke.py``'s phase 14 does. Prints one JSON object: per burst the
latency p50/p99 and requests/s, their medians, the int8 admission verdict
per bucket, the card's name and power limit. ``--port-root`` imports the
port from another checkout (a parent tree unpacked with ``git archive``),
so parent and change run the same burst in one call: run them in the order
parent, change, change, parent. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
PRESET = "northstar-iwae-2l-k50"
SIZES = [1, 3, 7, 17, 33, 64, 2, 5]
REQUESTS = 300


def _burst(np, eng, groups, seed0):
    done_at, submit_at, futures = {}, [], []
    t0 = time.perf_counter()
    seed = seed0
    for batch in groups:
        for row in batch:
            submit_at.append(time.perf_counter())
            f = eng.submit("score", row, seed=seed)
            f.add_done_callback(
                lambda _f, i=len(futures): done_at.__setitem__(
                    i, time.perf_counter()))
            futures.append(f)
            seed += 1
        time.sleep(0.0005)
    for f in futures:
        f.result(timeout=300)
    wall = time.perf_counter() - t0
    lat = np.array([done_at[i] - submit_at[i] for i in range(len(futures))])
    return {"p50_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3),
            "requests_per_s": len(futures) / wall}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port-root", default=str(HERE))
    ap.add_argument("--precision", default="fp32",
                    choices=["fp32", "int8"])
    ap.add_argument("--int8", default="auto", choices=["auto", "force"])
    ap.add_argument("--bursts", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.port_root).resolve()))
    if args.precision == "int8":
        os.environ["IWAE_SERVING_INT8"] = args.int8

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this measurement runs on the card",
              file=sys.stderr)
        return 1
    from iwae_replication_project_tpu_torch import zoo

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    eng = zoo.serving_engine(PRESET, seed=0, timeout_s=None,
                             precision=args.precision)
    t0 = time.perf_counter()
    warm = eng.warmup(ops=("score",))
    warm_s = time.perf_counter() - t0
    rng = np.random.RandomState(14)
    groups, n = [], 0
    while n < REQUESTS:
        size = SIZES[len(groups) % len(SIZES)]
        groups.append((rng.rand(size, 784) > 0.5).astype(np.float32))
        n += size
    eng.start()
    bursts = [_burst(np, eng, groups, 1000 * i) for i in range(args.bursts)]
    eng.stop()
    paths = {b: eng._kernel_for("score", eng.k, b)[1]
             for b in eng.ladder.buckets}
    out = {
        "metric": "flagship score burst", "port_root": args.port_root,
        "precision": args.precision,
        "int8": args.int8 if args.precision == "int8" else None,
        "card": smi, "requests": n, "warmup": warm,
        "warmup_seconds": round(warm_s, 3), "bursts": bursts,
        "p50_ms_median": float(np.median([b["p50_ms"] for b in bursts])),
        "requests_per_s_median": float(np.median(
            [b["requests_per_s"] for b in bursts])),
        "paths_by_bucket": paths,
        "int8_admission": {str(key[2]): why for key, why in getattr(
            eng, "int8_admission", {}).items()}}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

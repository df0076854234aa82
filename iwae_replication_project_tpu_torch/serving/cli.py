"""The serving CLI's synthetic-load mode (port of ``serving/cli.py``).

    python -m iwae_replication_project_tpu_torch.serving \\
        --preset northstar-iwae-2l-k50 --requests 200 [--device cpu]

Builds a zoo preset's engine with fresh weights (on ``cuda`` unless
``--device cpu``), warms its bucket ladder, drives an open-loop stream of
ragged request batches through the pipelined engine, and prints one JSON
summary: counters, per-bucket latency, requests per second and the device.
The JAX CLI's tier, client and interactive modes are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from iwae_replication_project_tpu_torch import zoo
from iwae_replication_project_tpu_torch.serving.batcher import (
    EngineOverloaded,
)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m iwae_replication_project_tpu_torch.serving",
        description="IWAE serving on PyTorch/CUDA: synthetic ragged load "
                    "against one zoo preset")
    ap.add_argument("--preset", default="northstar-iwae-2l-k50")
    ap.add_argument("--requests", type=int, default=200,
                    help="request batches to submit (each of one of --sizes "
                         "rows)")
    ap.add_argument("--sizes", default="1,3,7,17",
                    help="cycle of ragged batch sizes")
    ap.add_argument("--ops", default="score,encode,decode",
                    help="comma-separated ops to warm and cycle through")
    ap.add_argument("--k", type=int, default=None,
                    help="importance samples per score/encode request "
                         "(default: the preset's k)")
    ap.add_argument("--max-batch", dest="max_batch", type=int, default=64)
    ap.add_argument("--max-wait-us", dest="max_wait_us", type=float,
                    default=2000.0)
    ap.add_argument("--max-inflight", dest="max_inflight", type=int,
                    default=2)
    ap.add_argument("--timeout-s", dest="timeout_s", type=float, default=2.0,
                    help="per-request queue deadline; <= 0 disables")
    ap.add_argument("--kernel-path", dest="kernel_path", default=None,
                    choices=["kernel", "reference"])
    ap.add_argument("--precision", default=None, choices=["fp32", "bf16"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap


def synthetic_load(eng, ops, requests: int, sizes, seed: int) -> dict:
    """Open-loop ragged request stream; returns the final snapshot with wall
    time and throughput."""
    rng = np.random.RandomState(seed)
    eng.start()
    futures = []
    t0 = time.perf_counter()
    for i in range(requests):
        op = ops[i % len(ops)]
        n = sizes[i % len(sizes)]
        d = eng.row_dims[op]
        batch = (rng.rand(n, d) > 0.5).astype(np.float32) \
            if op != "decode" else rng.randn(n, d).astype(np.float32)
        for row in batch:
            try:
                futures.append(eng.submit(op, row))
            except EngineOverloaded:
                pass  # counted by the engine as shed
    failed = 0
    for f in futures:
        if f.exception() is not None:
            failed += 1   # timeouts/errors are counted in the snapshot too
    wall = time.perf_counter() - t0
    eng.stop()
    snap = eng.metrics.snapshot()
    snap["wall_seconds"] = wall
    snap["failed"] = failed
    snap["throughput_rows_per_sec"] = \
        snap["counters"]["completed"] / wall if wall else None
    return snap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    ops = tuple(s for s in args.ops.split(",") if s)
    sizes = [int(s) for s in args.sizes.split(",") if s]
    eng = zoo.serving_engine(
        args.preset, k=args.k, device=args.device,
        max_batch=args.max_batch, max_wait_us=args.max_wait_us,
        max_inflight=args.max_inflight,
        timeout_s=args.timeout_s if args.timeout_s > 0 else None,
        kernel_path=args.kernel_path, precision=args.precision,
        seed=args.seed)
    warm = eng.warmup(ops=ops)
    snap = synthetic_load(eng, ops, args.requests, sizes, args.seed)
    snap["warmup"] = warm
    snap["preset"] = args.preset
    snap["k"] = eng.k
    snap["buckets"] = list(eng.ladder.buckets)
    snap["device"] = (torch.cuda.get_device_name(eng.device)
                      if eng.device.type == "cuda" else "cpu")
    print(json.dumps(snap), flush=True)
    return 0 if snap["failed"] == 0 else 1

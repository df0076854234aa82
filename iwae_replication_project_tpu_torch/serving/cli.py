"""The serving CLI's in-process modes (port of ``serving/cli.py``).

    python -m iwae_replication_project_tpu_torch.serving \\
        [--preset NAME | --checkpoint RUN_DIR] [--interactive] [--device cpu]

Builds one engine (on ``cuda`` unless ``--device cpu``): from a driver
checkpoint run directory (``--checkpoint``, ``<checkpoint_dir>/<run_name>``:
the trained weights, served at the run's k unless ``--k``) or with fresh
weights of a zoo preset (``--preset``, default the flagship), warms its
bucket ladder and prints one JSON line (warmup, buckets, k), then:

* **synthetic load** (default): an open-loop stream of ragged request
  batches through the pipelined engine, then one JSON summary: counters,
  per-bucket latency, requests per second and the device; with
  ``--log-dir`` also stamped as JSONL (``utils/logging.MetricsLogger``);
* **interactive** (``--interactive``): JSON lines on stdin
  (``{"op": "score", "x": [[...pixels...]], "k": 50}``; ``encode`` and
  ``decode`` alike), one JSON result line per request on stdout, until
  EOF; a bad request prints an error line and the loop goes on.

The JAX CLI's tier, client, fleet, autoscale and metrics-page flags and the
int8 precision policy are refused with the ROADMAP item that will bring
them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from iwae_replication_project_tpu_torch import zoo
from iwae_replication_project_tpu_torch.serving.batcher import (
    EngineOverloaded,
)
from iwae_replication_project_tpu_torch.serving.buckets import BucketLadder
from iwae_replication_project_tpu_torch.utils.config import _refused

_TIER = "not ported yet: the serving frontend (ROADMAP A9)"
#: the JAX CLI's flags of modes the port lacks -> (reason, takes a value)
REFUSED = {
    "--replicas": (_TIER, True), "--port": (_TIER, True),
    "--host": (_TIER, True), "--models": (_TIER, True),
    "--max-outstanding": (_TIER, True), "--no-tracing": (_TIER, False),
    "--sharded-replicas": (_TIER, True), "--k-chunk": (_TIER, True),
    "--k-max": (_TIER, True), "--k-threshold": (_TIER, True),
    "--mesh-dp": (_TIER, True), "--mesh-sp": (_TIER, True),
    "--quota-rate": (_TIER, True), "--quota-burst": (_TIER, True),
    "--client": (_TIER, True), "--client-id": (_TIER, True),
    "--model": (_TIER, True), "--retries": (_TIER, True),
    "--hedge-after-s": (_TIER, True), "--retry-deadline-s": (_TIER, True),
    "--k-sweep": (_TIER, True), "--target-se": (_TIER, True),
    "--ess-floor": (_TIER, True), "--rate": (_TIER, True),
    "--autoscale": ("not ported yet: serving/fleet (ROADMAP A9)", False),
    "--metrics-port": ("not ported yet: the metrics page "
                       "(ROADMAP A10)", True),
    "--store-budget-mb": ("not ported yet: the executable store "
                          "(ROADMAP A10)", True),
    "--pin-core": ("the port runs on the card, not one pinned CPU core",
                   True),
}


def _precision(spec: str) -> str:
    if spec == "int8":
        raise argparse.ArgumentTypeError(
            "int8 is not ported yet: it waits for the serving_int8 autotune "
            "gate (ROADMAP A9 with A8)")
    if spec not in ("fp32", "bf16"):
        raise argparse.ArgumentTypeError(f"unknown precision {spec!r}; "
                                         f"expected fp32 or bf16")
    return spec


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m iwae_replication_project_tpu_torch.serving",
        description="IWAE serving on PyTorch/CUDA: one in-process engine "
                    "under synthetic ragged load or JSON lines on stdin")
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--checkpoint", default=None,
                     help="driver checkpoint run directory "
                          "(<checkpoint_dir>/<run_name>)")
    src.add_argument("--preset", default=None,
                     help="zoo preset naming the architecture (fresh, "
                          "untrained weights; default: the flagship "
                          "northstar-iwae-2l-k50)")
    ap.add_argument("--interactive", action="store_true",
                    help="serve JSON-lines requests from stdin instead of "
                         "synthetic load")
    ap.add_argument("--requests", type=int, default=200,
                    help="synthetic load: request batches to submit (each "
                         "of one of --sizes rows)")
    ap.add_argument("--sizes", default="1,3,7,17",
                    help="synthetic load: cycle of ragged batch sizes")
    ap.add_argument("--ops", default="score,encode,decode",
                    help="comma-separated ops to warm and cycle through")
    ap.add_argument("--k", type=int, default=None,
                    help="importance samples per score/encode request "
                         "(default: the preset's or checkpoint's k)")
    ap.add_argument("--max-batch", dest="max_batch", type=int, default=64)
    ap.add_argument("--buckets", default=None,
                    help="comma-separated explicit bucket ladder (e.g. '32' "
                         "pads every dispatch to one shape); default: "
                         "powers of two up to --max-batch")
    ap.add_argument("--max-wait-us", dest="max_wait_us", type=float,
                    default=2000.0)
    ap.add_argument("--queue-limit", dest="queue_limit", type=int,
                    default=1024)
    ap.add_argument("--max-inflight", dest="max_inflight", type=int,
                    default=2,
                    help="launched but uncompleted batches; 0 = serial")
    ap.add_argument("--timeout-s", dest="timeout_s", type=float, default=2.0,
                    help="per-request queue deadline; <= 0 disables")
    ap.add_argument("--kernel-path", dest="kernel_path", default=None,
                    choices=["kernel", "reference"])
    ap.add_argument("--precision", default=None, type=_precision,
                    help="fp32 | bf16 (int8 is not ported yet)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-dir", dest="log_dir", default=None,
                    help="also stamp the final metrics as JSONL under this "
                         "directory (utils/logging.MetricsLogger)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    for flag, (why, takes_value) in REFUSED.items():
        ap.add_argument(flag, action=_refused(why, takes_value),
                        help=argparse.SUPPRESS)
    return ap


def build_engine(args):
    """The engine the arguments describe."""
    ladder = BucketLadder(tuple(int(s) for s in args.buckets.split(",")
                                if s)) if args.buckets else None
    knobs = dict(k=args.k, device=args.device, max_batch=args.max_batch,
                 ladder=ladder, max_wait_us=args.max_wait_us,
                 queue_limit=args.queue_limit,
                 max_inflight=args.max_inflight,
                 timeout_s=args.timeout_s if args.timeout_s > 0 else None,
                 kernel_path=args.kernel_path, precision=args.precision,
                 seed=args.seed)
    if args.checkpoint:
        return zoo.serving_engine(checkpoint_dir=args.checkpoint, **knobs)
    return zoo.serving_engine(args.preset or "northstar-iwae-2l-k50",
                              **knobs)


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


def interactive(eng, lines) -> int:
    """Serve JSON-lines requests from `lines`, one JSON result line each
    on standard output; returns the number of error lines."""
    ops = {"score": eng.score, "encode": eng.encode, "decode": eng.decode}
    errors = 0
    eng.start()
    try:
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
                op = req.get("op", "score")
                if op not in ops:
                    raise ValueError(f"unknown op {op!r}; choose "
                                     f"{sorted(ops)}")
                kw = {"k": req["k"]} if "k" in req and op != "decode" \
                    else {}
                res = ops[op](req["x"], **kw)
                print(json.dumps({"op": op, "result": res.tolist()}),
                      flush=True)
            except Exception as e:  # a bad request must not end the loop
                errors += 1
                print(json.dumps({"error": f"{type(e).__name__}: {e}"}),
                      flush=True)
    finally:
        eng.stop()
    return errors


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    ops = tuple(s for s in args.ops.split(",") if s)
    eng = build_engine(args)
    warm = eng.warmup(ops=ops)
    device = (torch.cuda.get_device_name(eng.device)
              if eng.device.type == "cuda" else "cpu")
    print(json.dumps({"warmup": warm, "buckets": list(eng.ladder.buckets),
                      "k": eng.k, "device": device,
                      "source": args.checkpoint or args.preset
                      or "northstar-iwae-2l-k50"}), flush=True)
    if args.interactive:
        interactive(eng, sys.stdin)
        return 0
    sizes = [int(s) for s in args.sizes.split(",") if s]
    snap = synthetic_load(eng, ops, args.requests, sizes, args.seed)
    snap["warmup"] = warm
    snap["preset"] = args.preset
    snap["checkpoint"] = args.checkpoint
    snap["k"] = eng.k
    snap["buckets"] = list(eng.ladder.buckets)
    snap["device"] = device
    print(json.dumps(snap), flush=True)
    if args.log_dir:
        from iwae_replication_project_tpu_torch.utils.logging import (
            MetricsLogger)
        logger = MetricsLogger(args.log_dir, run_name="serving",
                               tensorboard=False)
        logger.log_registry(eng.metrics.registry,
                            step=int(snap["counters"]["dispatches"]))
        logger.close()
    return 0 if snap["failed"] == 0 else 1

#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``iwae_replication_project_tpu_torch``) on the card in
phases, one line per phase, and exits non-zero on the first failure:

1. the card's name and power limit (nvidia-smi), torch/CUDA versions and the
   TF32 flags (both set False: the plain versions must run in full fp32);
2. builds all six CUDA kernels from ``csrc/`` (one ``nvcc`` per source, all
   started together) and prints the build times and ptxas's
   register/shared-memory report;
3. holds each kernel against its plain PyTorch version on the card, within
   the stated tolerances, and times kernel and plain version two ways:
   ``kernel_ms``/``plain_ms``, CUDA events around 20 calls issued back to
   back (the method of every slice; where a call's host work outlasts its
   device work the device waits and the time shows it), and
   ``graph_ms``/``plain_graph_ms``, CUDA events around the replay of a
   CUDA graph of 20 calls (device time alone); ``host_us`` is the host time
   to issue one wrapper call. Beside them the kernel's bound, the achieved
   TFLOP/s and the bound share (bound ms / kernel ms) for both times, and
   B2's scratch bytes as its library states them: the hot-loop forward
   (``hot_loop_fwd``,
   B1) in fp32 and bf16 at the serving shapes (k=50 x B in {1, 7, 64}), the
   train shape (k=50, B=100), an odd shape and the eval chunk (k=250,
   B=500); the hot-loop backward (``hot_loop_bwd``, B2), per output, at the
   train shape, the eval chunk, an odd shape and odd widths, and bitwise
   across two launches; the fused Bernoulli log-likelihood's forward and
   backward (``fused_ll_fwd``, B3; ``fused_ll_bwd``, B4; 3xTF32 on the
   tensor cores) in fp32 at the flagship's last layer (H=200, D=784) at the
   train shape and the eval chunk and at an odd shape (k=13, B=17, D=130),
   dW and db bitwise across two launches, each timed line with both bounds
   (3xTF32 on the tensor cores, the JSON's; fp32 on the CUDA cores) and
   their shares, rows per CTA and B4's scratch bytes from its library;
   then the op's own path, ``fused_bernoulli_ll`` forward and backward on
   the flagship's last layer at the train shape, whose launches
   are counted, held against B1 (the same draws through the whole output
   block) and against B2's dW3 and db3 for the same cotangent; then the
   serving programs' row-invariant kernels (``row_dense``, ``row_sum``)
   against their plain versions at the flagship's serving shapes, timed
   beside ``torch.addmm`` and ``torch.sum``;
4. serves the flagship preset ``northstar-iwae-2l-k50`` at full width (fresh
   weights from the preset's seed, synthetic binary rows from a seed) through
   the pipelined engine: warmup, then a ragged stream of score requests plus
   a few encode and decode requests; prints latency and throughput, proves
   the kernel launched during that run, holds a handful of rows against a
   ``kernel_path="reference"`` engine of the same weights and seeds, and
   checks that every result is finite;
5. trains the same preset at full width with ``zoo.train`` for two Burda
   stages (1 + 3 passes over the synthetic set: 40 steps of k=50, B=100,
   bf16), each pass replaying the step's CUDA graph (its first step runs
   eagerly before the capture): per-pass losses (finite, falling), ms per
   step, a breakdown of one eager step, the per-stage evaluation
   run_experiment makes on the 256 synthetic test rows (the seven scalars
   at nll_k=5000), launches of both kernels across the replays (B2 equal to
   the step count; B1 the step count plus the eval launches derived from
   the config); then holds a step's per-leaf gradients against a
   ``hot_loop_path="reference"`` run on the same draws, and runs one DReG
   step at 1-layer width, which must launch the backward kernel twice;
   then (5b) four passes replayed from the graph against the same passes
   run eagerly from the same seed, bitwise equal in parameters, Adam
   moments, generator and losses, with each path's ms per step; and (5c)
   a bf16 model with a 256-wide output block, which the kernels refuse,
   training a pass and scoring through the reference path with no launch;
6. evaluates the trained flagship at full width with ``training_statistics``
   (eval_k=50, nll_k=5000 in chunks of 250, batches of 500) and the
   estimator diagnostics on 1000 synthetic test rows made from a seed:
   the seven scalars (finite, NLL <= -IWAE(k=50) up to noise), active
   units, seconds for the suite, ms per k=5000 NLL batch with B1's share,
   B1's launches (equal to the count derived from the config; B2 none), and
   one batch's NLL against a ``hot_loop_path="reference"`` model on the same
   generator seed;
7. runs the staged driver, ``run_experiment`` of the flagship with its
   checkpoints under a temporary directory and ``PASS_BLOCK`` set to 3: an
   uninterrupted 3-stage run, a run preempted by a ``sigterm`` fault point
   after stage 3's first block (the mid-stage checkpoint saved,
   ``TrainingPreempted`` raised), and its resume, whose parameters, Adam
   moments and generator must equal the uninterrupted run's bit for bit;
   the launches over the three runs (B2 once per step, B1 once per step
   plus each stage evaluation's count), the host ms per step of each stage,
   and of one dispatch of the real ``PASS_BLOCK`` (27 passes);
8. parallel, at flagship width: (a) an NCCL world of one process on mesh
   (1, 1): the parallel epoch replayed from its CUDA graph, the
   ``all_reduce`` captured in it, against the same passes run eagerly,
   bitwise, with B1 and B2 launched exactly once per step on both paths,
   and one pass on injected draws against the single-device epoch,
   bitwise; (b) a gloo world of 4 processes on the one card, mesh (2, 2):
   one IWAE and one DReG step's bound and per-leaf gradients against the
   single-process step on the same per-shard draws, and the sharded k=5000
   NLL of 500 rows against the single-device NLL on the same draws, with
   each rank's host ms per eager step (not speed numbers: gloo copies
   through the host); (c) ``python -m iwae_replication_project_tpu_torch
   --mesh-dp 1 --mesh-sp 1`` for 2 stages (one spawned NCCL rank);
9. the ``FlexibleModel`` facade at the example's architecture: at its
   defaults (no kernel) compile, fit one epoch, the k=5000 NLL of 100 rows
   and the statistics suite; a weights round trip, bitwise; one epoch with
   ``likelihood="logits"`` in bf16 (B1 and B2 once per step); and
   ``examples/experiment_example_torch.py --smoke``;
10. paper-grade k behind the serving API, with the weights of phase 7's
   checkpoint run directory: (a) ``ShardedScoreEngine(run_dir)``, a world
   of one (bf16 logits, k in blocks of 250 up to 5000, at most 8 rows a
   dispatch): a ragged stream of ``score`` requests at k in {1, 250, 251,
   1000, 5000} and 1-8 rows, then ``score_adaptive`` at k_cap 5000 with a
   ``target_se`` and an ``ess_floor``; B1's launches equal to the sum over
   the dispatches of ``ceil(k/250)`` (adaptive: the rounds run plus ``max
   ceil(k_used/250)``); every dispatch bitwise equal to the offline twin
   on the same padded rows; each early-stopped row bitwise the fixed-k
   score at its ``k_used``; k=5000 through the kernel against the
   reference path within ``TOL`` in bf16 and once in fp32; ms per k=5000
   dispatch of 8 rows (CUDA events and host clock), B1's share of it and
   rows per second; (b) a gloo world of 4 processes on the one card, mesh
   (2, 2): ``score`` at k=1000 and ``score_adaptive`` served by rank 0's
   engine (the followers in ``serve_rank`` until its ``stop()``), against
   the world of one on the same per-(row, block) draws within ``TOL``
   (adaptive rows against the world of one's fixed-k score at their
   ``k_used``), B1's launches summed over the ranks equal to the count
   derived from k and ``k_used``, and a world of 2 whose follower dies
   mid-dispatch: rank 0's future errors instead of hanging; (c) ``python
   -m iwae_replication_project_tpu_torch.serving --checkpoint RUN_DIR
   --interactive`` with one score and one encode line;
11. the serving tier over TCP, with the weights of phase 7's run directory:
   (a) a ``ServingTier`` on ``127.0.0.1:0`` over two fast replicas
   (``ServingEngine``, buckets 1-64, k=50) and one sharded replica
   (``ShardedScoreEngine``, a world of one, k in blocks of 250 up to 5000),
   large-k threshold 256, tracing on, a token-bucket quota on one client
   id, driven by a ``TierClient``: a lone request's p50 over the wire
   beside the same engine's in-process p50 (in turns), a ragged stream of
   200 score/encode/decode requests at k=50 in groups of 1-17 rows, 12
   ``score`` requests at k in {1000, 5000} and 8 ``score_adaptive`` at
   k_cap 5000 (p50/p99 latency on the host clock over the wire and
   requests per second per route); a fast replica crashed under a burst
   (``crash_replica``: every request answered, reroutes > 0); the quota'd
   client over-driven (typed ``quota_exceeded`` with ``retry_after_s``,
   then a ``RetryPolicy`` client gets through); the ``traces`` op (trees
   ``tier/request`` -> ``router/attempt-1`` -> the engine's stages); B1's
   launches over the phase equal to one per fast score dispatch plus
   ``ceil(k/250)`` per sharded score dispatch and the adaptive rule per
   ``score_adaptive`` one; every fast-route row against one direct
   in-process engine on the same (row, seed, k), each request replayed
   alone in its own bucket, bitwise; every large-k
   dispatch bitwise its offline twin; (b) the CLI's tier mode from the run
   directory (``--replicas 2 --sharded-replicas 1 --port 0``, stdin held
   open) and its client mode (``--requests 40 --k-sweep 250,5000
   --target-se 0.5``), both exiting 0 after stdin EOF;
12. the elastic multi-model tier: (a) every row of a seeded set served in
   each bucket 1..64 beside other neighbours, bitwise the same (score,
   encode, decode; bf16 and fp32), and a k=5000 row of the sharded engine
   in buckets 1, 2, 4 and 8; (b) every (op, bucket) program of the flagship
   captured into the executable store: replay bitwise eager, capture ms,
   replay and eager device ms, the bill (the larger of the bytes reckoned
   from the shapes and the bytes the capture holds, C7), an eviction's
   bytes given back; (c) three full-width presets behind one TCP
   tier (``zoo.serving_engines``) under a store budget of about one
   model's programs: a burst alternating the models, all ok and bitwise a
   dedicated engine's, evictions and readmits with no kernel build, B1's
   launches equal to the score dispatches, ``crash_aot_dispatch`` failing
   one request, typed; (d) the autoscaler (JAX
   ``scripts/autoscale_smoke.py``'s claims at full width): up on a burn
   breach with a warm join (0 captures, 0 builds), the joined replica
   crashed and a second scale-up, down on idle by drain, every response
   bitwise a static tier's, the decision log printed; (e) the CLI's
   ``--replicas 1 --models A,B --store-budget-mb X --autoscale
   --autoscale-max 2`` with a ``--client`` burst per model;
13. the observability plane, with the weights of phase 7's run directory:
   (a) two flagship engines, profiling on and off, the same ragged score
   stream (groups of 1-64 rows at k=50): rows bitwise the same, B1's
   launches equal to the score dispatches, ``detect_chip_peaks()`` naming
   the H100 row, per profiler key its count, EWMA and p50 device ms, MFU,
   HBM fraction and ceiling ratio, score/b64 beside phase 12b's replay, the
   drift findings and the largest z; (b) the sharded engine's profiler at
   the request's k under "dyn" and at the rows' ``k_used``; (c) the CLI's
   tier mode with ``--metrics-port 0`` (/metrics, /healthz, /traces, /prof)
   and the trace dump (``telemetry/trace_cli``) against it, then engine
   mode's page; (d) one score dispatch under ``utils.profiling.trace``:
   the ``serve/dispatch/score`` range and B1's kernel in the Chrome trace;
   (e) the driver's ``span/*`` names and p50 from phase 7; (f) C7: after
   phase 12c's burst the resident entries hold at most the budget plus the
   largest entry, every bill at least its pool bytes;
14. prints the kernels' JSON record (launches of the serving and training
   runs, and per path of phases 8-13 under ``launches_by_path``) and, last,
   the contract line ``{"ok": true, "device": {...}}``.

Without a CUDA device, or run outside a checkout of the repository, it exits
non-zero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import datetime
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

#: kernel vs plain version on the card: (atol, rtol) per compute dtype.
#: fp32: the same fp32 arithmetic summed in another order (K <= 200 terms per
#: logit, 784 pixel terms per row; rows are sums of a few hundred to a few
#: thousand nats). bf16: both round the same operands to bf16 and sum in
#: fp32, but a pre-activation within an fp32 rounding of a bf16 midpoint can
#: round to the neighbouring bf16 value in one and not the other. Measured on
#: an H100 the worst row differed by 1.2e-4 nats in both dtypes; a wrong
#: kernel is off by whole nats or more.
TOL = {"fp32": (2e-3, 1e-5), "bf16": (1e-2, 1e-5)}

#: H100 SXM peaks (NVIDIA data sheet, dense): fp32 on the CUDA cores, bf16
#: and TF32 on the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12, "tf32": 494.7e12}
PEAK_BYTES = 3.35e12

#: backward kernel vs its plain version on the card, per output, relative
#: to the output's largest magnitude. fp32: the same arithmetic summed in
#: another order (weight gradients sum up to 125000 rows of both signs).
#: bf16: both round the same operands, but an operand within an fp32
#: rounding of a bf16 midpoint may round to the neighbouring bf16 value on
#: one side only (2^-8 relative) and spread through the later products.
BWD_TOL = {"fp32": 1e-4, "bf16": 1e-2}
#: a train step's gradients through the kernels vs plain autograd of the
#: reference composition, per leaf, relative to the leaf's largest
#: magnitude: in bf16 autograd rounds each operand's gradient at the casts
#: where the kernels round the cotangents as matmul operands (2^-8 relative
#: per layer; 7.2e-3 at worst in the CPU parity tests)
GRAD_TOL = 2e-2

#: the fused Bernoulli log-likelihood's kernels (B3, B4) vs their plain
#: versions, fp32 only (the op takes fp32): 3xTF32 products, ~2^-22
#: relative error each (tests/test_torch_tf32_split.py), summed in another
#: order. Forward (atol, rtol) as B1's fp32; backward relative to
#: each output's largest magnitude, as B2's fp32. The same tolerances hold
#: B3 against B1 and B4's dW, db against B2's dW3, db3 on the same draws:
#: there the last layer's input y2 is computed by cuBLAS on one side and
#: inside B1/B2 on the other, another summation order again.
FLL_TOL = (2e-3, 1e-5)
FLL_BWD_TOL = 1e-4

#: one eval batch's k=5000 NLL through the kernel vs the reference path on
#: the same draws: the bf16 row tolerance of TOL (a mean of per-row
#: estimates, each a logmeanexp of rows that differ by at most that)
NLL_TOL = TOL["bf16"]

FLAGSHIP = dict(h1=100, hid=200, d=784)
PRESET = "northstar-iwae-2l-k50"
TRAIN_K, TRAIN_B = 50, 100
#: the full-width evaluation: synthetic test rows, and the generator seed of
#: the NLL held against the reference path
EVAL_ROWS, NLL_SEED = 1000, 5
#: the shapes B1 and B2 take on one rank of the phase-8 meshes: the train
#: step on dp=2 (k=50 x B=50) and on dp=2 x sp=2 (k=25 x B=50), and the
#: k=5000 NLL chunk on dp=2 (250 x 250)
RANK_SHAPES_FWD = [("rank-train-dp2", 50, 50, FLAGSHIP),
                   ("rank-train-dp2sp2", 25, 50, FLAGSHIP),
                   ("rank-eval-dp2", 250, 250, FLAGSHIP)]
RANK_SHAPES_BWD = RANK_SHAPES_FWD[:2]
#: phase 8b: the gloo mesh on the one card, and the sharded NLL's rows
GLOO_MESH, NLL_ROWS, NLL_K, NLL_CHUNK = (2, 2), 500, 5000, 250
#: phase 10: the sharded engine's sample block, admission bound and largest
#: bucket; its ragged stream of (k, rows) score groups; the adaptive
#: targets (one group each, at k_cap = SHARDED_KMAX)
SHARDED_KC, SHARDED_KMAX, SHARDED_BATCH = 250, 5000, 8
SHARDED_STREAM = [(1, 1), (250, 3), (251, 8), (1000, 5), (5000, 8), (251, 2),
                  (1000, 8), (5000, 2), (250, 7), (5000, 8), (1, 6), (1000, 1)]
ADAPTIVE_TARGETS = [{"target_se": 0.5}, {"ess_floor": 20.0}]
#: phase 10b's score k on the gloo mesh
SHARDED_GLOO_K = 1000
#: the shapes B1 takes on that path: a full bucket in a world of one, and
#: a rank's rows of a full bucket on dp=2
SHARDED_SHAPES_FWD = [("sharded-b8", SHARDED_KC, 8, FLAGSHIP),
                      ("sharded-dp2", SHARDED_KC, 4, FLAGSHIP)]
#: phase 11, the tier: the large-k threshold (also the fast replicas'
#: k_max), the quota (rate rows/s, burst rows) on one client id, the lone
#: requests timed each way, the fast route's requests and their cycle of
#: row counts, the large-k score requests' k, the score_adaptive requests
#: and the crash burst
TIER_THRESHOLD = 256
TIER_QUOTA, TIER_TENANT = (20.0, 8.0), "tenant-q"
TIER_LONE = 30
TIER_FAST_REQUESTS = 200
TIER_SIZES = [1, 3, 17, 1, 7, 2, 1, 12, 5, 1]
TIER_LARGE_K = [1000, 5000] * 6
TIER_ADAPTIVE = 8
TIER_CRASH_REQUESTS = 60
#: phase 12: the multi-model tier's presets (full width; fresh weights from
#: each preset's seed) and its burst; the autoscaler's burst phases and its
#: SLO windows (seconds, under the controller's labels "5m" and "1h")
MM_PRESETS = ["northstar-iwae-2l-k50", "table1-iwae-1l-k50",
              "table3-iwae-2l-k50"]
MM_REQUESTS = 90
AS_PHASE = 12
AS_FAST_S, AS_SLOW_S = 2.0, 4.0
#: phase 13: the profiled score stream (groups of 1-64 rows at the
#: flagship's k=50, every fourth a full 64-row group) and the sharded
#: engine's score k and dispatches
OBS_GROUPS = 48
OBS_SHARDED = [(5000, 3), (1000, 8), (5000, 1)]


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", flush=True)
    return 1


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(fn, torch, iters: int = 20) -> float:
    """Mean time of one call over `iters` back-to-back calls, after warming
    up, measured with CUDA events (host launch overhead included where the
    device waits for it): phase 3's ``kernel_ms`` and ``plain_ms``, as in
    every slice of the port."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, torch, iters: int = 20, rounds: int = 5) -> float:
    """Host time to issue one call, in microseconds: the median over
    `rounds` of the mean over `iters` back-to-back calls, after warming up,
    the device not waited for."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    res = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        res.append((time.perf_counter() - t0) / iters * 1e6)
        torch.cuda.synchronize()
    return sorted(res)[rounds // 2]


def timings(fn, plain, torch) -> dict:
    """Phase 3's times of a kernel's wrapper `fn` and its plain version."""
    return dict(ms=time_ms(fn, torch), graph_ms=device_ms(fn, torch),
                plain_ms=time_ms(plain, torch),
                plain_graph_ms=device_ms(plain, torch),
                host_us=host_us(fn, torch))


def timing_text(t: dict, bound: float, by: str, flops=None) -> str:
    """The timing part of a phase-3 line."""
    text = (f" | kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
            f"(back to back) graph_ms={t['graph_ms']:.4f} plain_graph_ms="
            f"{t['plain_graph_ms']:.4f} host_us={t['host_us']:.1f} "
            f"bound_ms={bound:.5f} ({by})")
    if flops is not None:
        text += (f" achieved_tflops={flops / t['ms'] / 1e9:.2f} "
                 f"bound_share={bound / t['ms']:.2%} graph_achieved_tflops="
                 f"{flops / t['graph_ms'] / 1e9:.2f} graph_bound_share="
                 f"{bound / t['graph_ms']:.2%}")
    return text


def device_ms(fn, torch, iters: int = 20) -> float:
    """Device time of one call: CUDA events around the replay of a CUDA
    graph of `iters` calls, captured after a warm-up on a side stream. The
    wrappers' Python and launch overhead is not in it, for kernels and plain
    versions alike."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def hot_loop_inputs(torch, k, b, h1, hid, d, seed):
    """Random decoder-block inputs on the card, drawn on the host."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).cuda()

    x = (torch.rand((b, d), generator=g) > 0.5).float().cuda()
    return (r(k, b, h1), r(h1, hid, scale=0.2), r(hid, scale=0.1),
            r(hid, hid, scale=0.1), r(hid, scale=0.1), r(hid, d, scale=0.1),
            r(d, scale=0.1), x)


def hot_loop_bound_ms(k, b, h1, hid, d, dtype) -> tuple:
    """(bound_ms, bound_by): the larger of the operations over the dtype's
    peak and the bytes that must move (each input read once, the output
    written once) over HBM bandwidth."""
    rows = k * b
    flops = 2.0 * rows * (h1 * hid + hid * hid + hid * d)
    nbytes = 4.0 * (rows * h1 + h1 * hid + hid + hid * hid + hid + hid * d
                    + d + b * d + rows)
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_hot_loop(torch, hot_loop):
    """Phase 3: kernel vs plain version; returns (record for the JSON line,
    ok, {(dtype, tag, B): kernel ms})."""
    shapes = [("serve", 50, 1, FLAGSHIP), ("serve", 50, 7, FLAGSHIP),
              ("serve", 50, 64, FLAGSHIP), ("train", TRAIN_K, TRAIN_B, FLAGSHIP),
              ("odd", 13, 17, FLAGSHIP),
              ("odd-widths", 3, 5, dict(h1=37, hid=70, d=130)),
              ("eval", 250, 500, FLAGSHIP)] + RANK_SHAPES_FWD \
        + SHARDED_SHAPES_FWD
    ok = True
    worst = 0.0
    main = None
    times = {}
    for dtype in ("fp32", "bf16"):
        cd = torch.bfloat16 if dtype == "bf16" else None
        atol, rtol = TOL[dtype]
        for i, (tag, k, b, w) in enumerate(shapes):
            args = hot_loop_inputs(torch, k, b, w["h1"], w["hid"], w["d"],
                                   seed=i)
            got = hot_loop.fused_forward(*args, compute_dtype=cd)
            want = hot_loop._reference_impl(*args, compute_dtype=cd)
            torch.cuda.synchronize()
            err = (got - want).abs()
            max_abs = float(err.max())
            max_rel = float((err / want.abs().clamp_min(1e-6)).max())
            within = bool((err <= atol + rtol * want.abs()).all()) and \
                bool(torch.isfinite(got).all())
            worst = max(worst, max_abs)
            line = (f"kernel hot_loop_fwd {dtype} {tag} k={k} B={b} "
                    f"H1={w['h1']} hid={w['hid']} D={w['d']}: "
                    f"max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
                    f"tol=({atol:g} + {rtol:g}*|ref|) "
                    f"{'ok' if within else 'OUT OF TOLERANCE'}")
            ok &= within
            if tag in ("serve", "train", "eval") or \
                    tag.startswith(("rank", "sharded")):
                t = timings(
                    lambda: hot_loop.fused_forward(*args, compute_dtype=cd),
                    lambda: hot_loop._reference_impl(*args, compute_dtype=cd),
                    torch)
                times[(dtype, tag, b)] = t["ms"]
                bound, by = hot_loop_bound_ms(k, b, w["h1"], w["hid"],
                                              w["d"], dtype)
                flops = 2.0 * k * b * (w["h1"] * w["hid"] + w["hid"] ** 2
                                       + w["hid"] * w["d"])
                line += timing_text(t, bound, by, flops)
                if dtype == "bf16" and tag == "serve" and b == 64:
                    main = dict(t, bound_ms=bound, bound_by=by)
            print(line, flush=True)
    record = {"name": "hot_loop_fwd", "route": "cuda",
              "source": "iwae_replication_project_tpu_torch/csrc/"
                        "hot_loop_fwd.cu",
              "replaces": "iwae_replication_project_tpu/ops/hot_loop.py:633",
              "launches": None, "max_abs_err": worst, **main,
              "library_ms": None,
              "bound_share": main["bound_ms"] / main["ms"]}
    return record, ok, times


def breakdown(torch, np, eng):
    """Where one full (64-row) score dispatch spends its time: the per-row
    noise draw on the host and the score program on the device (noise
    already there; CUDA events). Phase 3 times the kernel inside it."""
    from iwae_replication_project_tpu_torch.serving.programs import (
        draw_noise, score_rows)

    cfg, _ = eng._kernel_for("score")
    seeds = list(range(64))
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        noise = draw_noise(cfg, "score", 0, seeds, eng.k)
        host.append(time.perf_counter() - t0)
    x = (torch.rand((64, cfg.x_dim), generator=torch.Generator()
                    .manual_seed(0)) > 0.5).float().cuda()
    noise = [t.cuda() for t in noise]
    prog = time_ms(lambda: score_rows(eng._params, cfg, 0, seeds, x, eng.k,
                                      noise=noise), torch)
    print(f"serve: breakdown of one 64-row score dispatch: host noise draw "
          f"{np.median(host) * 1e3:.3f} ms (host clock, median of 5); score "
          f"program on the device {prog:.4f} ms (CUDA events)", flush=True)


def serve(torch, np, zoo, hot_loop):
    """Phase 4: the flagship preset through the pipelined engine. Returns
    ({kernel: launches during the served run}: B1 and the row-invariant
    kernels, ok)."""
    from iwae_replication_project_tpu_torch.ops import row_invariant as ri

    eng = zoo.serving_engine(PRESET, seed=0, timeout_s=None)
    ref = zoo.serving_engine(PRESET, seed=0, timeout_s=None,
                             kernel_path="reference")
    print(f"serve: preset={PRESET} device={eng.device} k={eng.k} "
          f"compute_dtype={eng.cfg.compute_dtype} "
          f"buckets={list(eng.ladder.buckets)} "
          f"max_inflight={eng.max_inflight}", flush=True)
    warm = eng.warmup()
    print(f"serve: warmup {warm}", flush=True)

    rng = np.random.RandomState(0)
    sizes = [1, 3, 7, 17, 33, 64, 2, 5]
    score_rows, score_seeds = [], []
    n_score = 0
    while n_score < 300:
        n = sizes[len(score_rows) % len(sizes)]
        score_rows.append((rng.rand(n, 784) > 0.5).astype(np.float32))
        n_score += n
    enc_rows = (rng.rand(8, 784) > 0.5).astype(np.float32)
    dec_rows = rng.randn(8, eng.row_dims["decode"]).astype(np.float32)

    done_at = {}

    def stamp(i):
        return lambda _f: done_at.__setitem__(i, time.perf_counter())

    hot_loop.reset_launch_counts()
    ri.reset_launch_counts()
    eng.start()
    t0 = time.perf_counter()
    futures, submit_at, seed = [], [], 0
    for batch in score_rows:
        for row in batch:
            submit_at.append(time.perf_counter())
            f = eng.submit("score", row, seed=seed)
            f.add_done_callback(stamp(len(futures)))
            futures.append(f)
            score_seeds.append(seed)
            seed += 1
        time.sleep(0.0005)
    enc_f = [eng.submit("encode", r, seed=1000 + i)
             for i, r in enumerate(enc_rows)]
    dec_f = [eng.submit("decode", r, seed=2000 + i)
             for i, r in enumerate(dec_rows)]
    scores = np.array([f.result(timeout=300) for f in futures])
    wall = time.perf_counter() - t0
    encs = np.stack([f.result(timeout=300) for f in enc_f])
    decs = np.stack([f.result(timeout=300) for f in dec_f])
    eng.stop()
    launches = hot_loop.launch_counts()[hot_loop.KERNEL]
    row_launches = ri.launch_counts()
    snap = eng.metrics.snapshot()

    lone = []
    eng.start()
    for i in range(30):
        t1 = time.perf_counter()
        eng.submit("score", score_rows[0][0], seed=5000 + i).result(timeout=60)
        lone.append(time.perf_counter() - t1)
    eng.stop()
    breakdown(torch, np, eng)

    lat = np.array([done_at[i] - submit_at[i] for i in range(len(futures))])
    paths = {key: rec["path"] for key, rec in snap["kernel"].items()
             if key.startswith("score/")}
    print(f"serve: {len(futures)} score + {len(enc_f)} encode + "
          f"{len(dec_f)} decode requests, dispatches="
          f"{snap['counters']['dispatches']} padding_waste="
          f"{snap['padding_waste']:.3f}", flush=True)
    print(f"serve: score latency p50_ms={np.percentile(lat, 50) * 1e3:.3f} "
          f"p99_ms={np.percentile(lat, 99) * 1e3:.3f} "
          f"requests_per_s={len(futures) / wall:.1f} wall_s={wall:.3f}",
          flush=True)
    print(f"serve: lone score request (closed loop, 30 requests) latency "
          f"p50_ms={np.percentile(lone, 50) * 1e3:.3f} "
          f"p99_ms={np.percentile(lone, 99) * 1e3:.3f}", flush=True)
    print(f"serve: hot_loop_fwd launches during the run = {launches}; "
          f"row-invariant kernels {row_launches}; score kernel stamps = "
          f"{sorted(set(paths.values()))}; store counters "
          + str({k: snap["counters"][k]
                 for k in ("aot_hits", "aot_misses", "recompiles")}),
          flush=True)
    ok = True
    if launches <= 0 or min(row_launches.values()) <= 0:
        ok = False
        print("FAIL: a kernel was not launched by the served run")
    if set(paths.values()) != {"kernel"}:
        ok = False
        print(f"FAIL: score dispatches stamped {paths}")
    finite = bool(np.isfinite(scores).all() and np.isfinite(encs).all()
                  and np.isfinite(decs).all())
    shapes_ok = scores.shape == (len(futures),) and encs.shape == (8, 50) \
        and decs.shape == (8, 784)
    print(f"serve: all results finite={finite} shapes_ok={shapes_ok}",
          flush=True)
    ok &= finite and shapes_ok

    # a handful of rows against the reference-pinned engine, same seeds
    idx = list(range(0, len(futures), max(1, len(futures) // 24)))[:24]
    flat = np.concatenate(score_rows)
    ref_f = [ref.submit("score", flat[i], seed=score_seeds[i]) for i in idx]
    ref.flush()
    want = np.array([f.result() for f in ref_f])
    atol, rtol = TOL["bf16" if eng.cfg.compute_dtype else "fp32"]
    err = np.abs(scores[idx] - want)
    within = bool((err <= atol + rtol * np.abs(want)).all())
    print(f"serve: {len(idx)} score rows vs reference engine: "
          f"max_abs_err={err.max():.3e} tol=({atol:g} + {rtol:g}*|ref|) "
          f"{'ok' if within else 'OUT OF TOLERANCE'}", flush=True)
    ok &= within
    # encode/decode never touch B1: the two engines run the same
    # row-invariant programs, so latents and probabilities agree to well
    # under 1e-2 (bitwise where the rows' bits are the same)
    enc_want = [ref.submit("encode", r, seed=1000 + i)
                for i, r in enumerate(enc_rows)]
    dec_want = [ref.submit("decode", r, seed=2000 + i)
                for i, r in enumerate(dec_rows)]
    ref.flush()
    enc_err = np.abs(encs - np.stack([f.result() for f in enc_want])).max()
    dec_err = np.abs(decs - np.stack([f.result() for f in dec_want])).max()
    side_ok = bool(enc_err <= 1e-2 and dec_err <= 1e-2)
    print(f"serve: encode/decode vs reference engine: max_abs_err "
          f"{enc_err:.3e}/{dec_err:.3e} tol=1e-2 "
          f"{'ok' if side_ok else 'OUT OF TOLERANCE'}", flush=True)
    return {hot_loop.KERNEL: launches, **row_launches}, ok and side_ok


def hot_loop_bwd_bound_ms(k, b, h1, hid, d, dtype) -> tuple:
    """(bound_ms, bound_by) of the backward: the recompute plus two backward
    products per matmul, 6 * R * (H1*HID + HID^2 + HID*D) operations; bytes
    h1, g, x and the weights read once, dh and the weight gradients written
    once, 4 bytes each."""
    rows = k * b
    flops = 6.0 * rows * (h1 * hid + hid * hid + hid * d)
    weights = h1 * hid + hid + hid * hid + hid + hid * d + d
    nbytes = 4.0 * (rows * h1 + rows + b * d + weights + rows * h1 + weights)
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


OUTPUTS = ("dh", "dW1", "db1", "dW2", "db2", "dW3", "db3")
#: the evaluation suite's seven scalars (evaluation.metrics.SCALAR_NAMES)
SCALARS = ("VAE", "IWAE", "NLL", "E_q(h|x)[log(p(x|h))]",
           "D_kl(q(h|x),p(h))", "D_kl(q(h|x),p(h|x))", "reconstruction_loss")


def check_hot_loop_bwd(torch, hot_loop, lib):
    """Phase 3b: the backward kernel vs its plain version, per output, and
    bitwise across two launches; returns (record for the JSON line, ok).
    `lib` is the kernel's loaded library, which states its scratch bytes."""
    shapes = [("train", TRAIN_K, TRAIN_B, FLAGSHIP), ("odd", 13, 17, FLAGSHIP),
              ("odd-widths", 3, 5, dict(h1=37, hid=70, d=130)),
              ("eval", 250, 500, FLAGSHIP)] + RANK_SHAPES_BWD
    ok = True
    worst = 0.0
    main = None
    for dtype in ("fp32", "bf16"):
        cd = torch.bfloat16 if dtype == "bf16" else None
        rel = BWD_TOL[dtype]
        for i, (tag, k, b, w) in enumerate(shapes):
            args = hot_loop_inputs(torch, k, b, w["h1"], w["hid"], w["d"],
                                   seed=100 + i)
            g = torch.randn((k, b), generator=torch.Generator()
                            .manual_seed(200 + i)).cuda()
            got = hot_loop.fused_backward(*args, g, compute_dtype=cd)
            again = hot_loop.fused_backward(*args, g, compute_dtype=cd)
            want = hot_loop._bwd_plain(*args, g, compute_dtype=cd)
            torch.cuda.synchronize()
            bitwise = all(bool(torch.equal(a, c)) for a, c in zip(got, again))
            parts = []
            within = bitwise
            for name, a, ref in zip(OUTPUTS, got, want):
                err = (a - ref).abs()
                max_abs = float(err.max())
                scale = float(ref.abs().max())
                max_rel = float((err / ref.abs().clamp_min(1e-6)).max())
                fine = max_abs <= rel * scale + 1e-6 and \
                    bool(torch.isfinite(a).all())
                within &= fine
                worst = max(worst, max_abs / max(scale, 1e-12))
                parts.append(f"{name} abs={max_abs:.2e} rel={max_rel:.1e} "
                             f"of_max={max_abs / max(scale, 1e-12):.1e}"
                             f"{'' if fine else ' OUT'}")
            line = (f"kernel hot_loop_bwd {dtype} {tag} k={k} B={b} "
                    f"H1={w['h1']} hid={w['hid']} D={w['d']}: "
                    f"tol={rel:g}*max|ref| bitwise_repeat={bitwise} "
                    f"{'ok' if within else 'OUT OF TOLERANCE'} | "
                    + "; ".join(parts))
            ok &= within
            if tag in ("train", "eval") or tag.startswith("rank"):
                t = timings(
                    lambda: hot_loop.fused_backward(*args, g, cd),
                    lambda: hot_loop._bwd_plain(*args, g, cd), torch)
                bound, by = hot_loop_bwd_bound_ms(k, b, w["h1"], w["hid"],
                                                  w["d"], dtype)
                flops = 6.0 * k * b * (w["h1"] * w["hid"] + w["hid"] ** 2
                                       + w["hid"] * w["d"])
                scratch = lib.hot_loop_bwd_scratch_bytes(
                    k * b, w["h1"], w["hid"], w["d"], int(dtype == "bf16"))
                line += (timing_text(t, bound, by, flops)
                         + f" scratch_bytes={scratch}")
                if dtype == "bf16" and tag == "train":
                    main = dict(t, bound_ms=bound, bound_by=by)
            print(line, flush=True)
            del args, got, again, want
    record = {"name": "hot_loop_bwd", "route": "cuda",
              "source": "iwae_replication_project_tpu_torch/csrc/"
                        "hot_loop_bwd.cu",
              "replaces": "iwae_replication_project_tpu/ops/hot_loop.py:698",
              "launches": None, "max_abs_err": worst, **main,
              "library_ms": None,
              "bound_share": main["bound_ms"] / main["ms"]}
    return record, ok


def fll_inputs(torch, k, b, h, d, seed):
    """Random last-layer inputs and a cotangent on the card, drawn on the
    host."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((k, b, h), generator=g).cuda(),
            (torch.randn((h, d), generator=g) * 0.1).cuda(),
            (torch.randn((d,), generator=g) * 0.1).cuda(),
            (torch.rand((b, d), generator=g) > 0.5).float().cuda(),
            torch.randn((k, b), generator=g).cuda()]


def fused_ll_bounds(k, b, h, d, backward) -> dict:
    """The bounds of B3 (2 * R * H * D operations) or B4 (6 * R * H * D: the
    recompute and two backward products) as ``{name: (bound_ms, bound_by)}``:
    ``"tc"``, the fp32-accurate work as the kernels do it on the tensor
    cores, three TF32 products each (3xTF32); ``"cuda_cores"``, fp32 on the
    CUDA cores (the yardstick kept for comparison). Bytes: h, W, bias, x
    (and g) read once, out (or dh, dW, db) written once, 4 bytes each."""
    rows = k * b
    flops = (6.0 if backward else 2.0) * rows * h * d
    nbytes = 4.0 * (rows * h + h * d + d + b * d + rows)
    if backward:
        nbytes += 4.0 * (rows * h + h * d + d)
    t_bytes = nbytes / PEAK_BYTES
    out = {}
    for name, t_ops in (("tc", 3 * flops / PEAK_FLOPS["tf32"]),
                        ("cuda_cores", flops / PEAK_FLOPS["fp32"])):
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def outputs_within(torch, got, want, rel) -> tuple:
    """(every output within rel * its max |want|, worst err / max, text)."""
    fine, worst, parts = True, 0.0, []
    for name, a, ref in zip(("dh", "dW", "db"), got, want):
        err = float((a - ref).abs().max())
        scale = max(float(ref.abs().max()), 1e-12)
        ok = err <= rel * scale + 1e-6 and bool(torch.isfinite(a).all())
        fine &= ok
        worst = max(worst, err / scale)
        parts.append(f"{name} abs={err:.2e} of_max={err / scale:.1e}"
                     f"{'' if ok else ' OUT'}")
    return fine, worst, "; ".join(parts)


def check_fused_ll(torch, fl, libs):
    """Phase 3c: B3 and B4 vs their plain versions in fp32, B4 bitwise
    across two launches; returns (records for the JSON line, ok). `libs`
    are the two kernels' loaded libraries, which state B4's scratch bytes
    and each kernel's rows per CTA."""
    lib_f, lib_b = libs
    shapes = [("train", TRAIN_K, TRAIN_B, 200, 784),
              ("eval", 250, 500, 200, 784), ("odd", 13, 17, 200, 130)]
    ok = True
    worst_f = worst_b = 0.0
    main = {}
    for i, (tag, k, b, h, d) in enumerate(shapes):
        h1, w, bias, x, g = fll_inputs(torch, k, b, h, d, seed=300 + i)
        got = fl.fused_ll_forward(h1, w, bias, x)
        want = fl._reference_impl(h1, w, bias, x)
        grads = fl.fused_ll_backward(h1, w, bias, x, g)
        again = fl.fused_ll_backward(h1, w, bias, x, g)
        want_g = fl._bwd_plain(h1, w, bias, x, g)
        torch.cuda.synchronize()
        err = (got - want).abs()
        fwd_ok = bool((err <= FLL_TOL[0] + FLL_TOL[1] * want.abs()).all()) \
            and bool(torch.isfinite(got).all())
        worst_f = max(worst_f, float(err.max()))
        bitwise = all(bool(torch.equal(a, c)) for a, c in zip(grads, again))
        bwd_ok, worst, text = outputs_within(torch, grads, want_g,
                                             FLL_BWD_TOL)
        worst_b = max(worst_b, worst)
        ok &= fwd_ok and bwd_ok and bitwise
        fwd_line = (f"kernel fused_ll_fwd fp32 {tag} k={k} B={b} H={h} "
                    f"D={d}: max_abs_err={float(err.max()):.3e} "
                    f"tol=({FLL_TOL[0]:g} + {FLL_TOL[1]:g}*|ref|) "
                    f"{'ok' if fwd_ok else 'OUT OF TOLERANCE'}")
        bwd_line = (f"kernel fused_ll_bwd fp32 {tag} k={k} B={b} H={h} "
                    f"D={d}: tol={FLL_BWD_TOL:g}*max|ref| bitwise_repeat="
                    f"{bitwise} {'ok' if bwd_ok and bitwise else 'FAIL'} | "
                    + text)
        if tag in ("train", "eval"):
            for name, fn, plain, bwd in (
                    ("fwd", lambda: fl.fused_ll_forward(h1, w, bias, x),
                     lambda: fl._reference_impl(h1, w, bias, x), False),
                    ("bwd", lambda: fl.fused_ll_backward(h1, w, bias, x, g),
                     lambda: fl._bwd_plain(h1, w, bias, x, g), True)):
                t = timings(fn, plain, torch)
                bounds = fused_ll_bounds(k, b, h, d, bwd)
                bound, by = bounds["tc"]
                cc, cc_by = bounds["cuda_cores"]
                flops = (6.0 if bwd else 2.0) * k * b * h * d
                text = (timing_text(t, bound, by, flops)
                        + f" (3xTF32 tensor-core bound) fp32_cuda_core_"
                        f"bound_ms={cc:.5f} ({cc_by}) fp32_cuda_core_bound_"
                        f"share={cc / t['ms']:.2%}")
                if bwd:
                    scratch = lib_b.fused_ll_bwd_scratch_bytes(k * b, h, d)
                    bwd_line += text + (
                        f" scratch_bytes={scratch}"
                        f" cta_rows={lib_b.fused_ll_bwd_cta_rows(k * b, h)}"
                        f" splits={lib_b.fused_ll_bwd_splits(k * b)}")
                else:
                    fwd_line += text + (
                        f" cta_rows={lib_f.fused_ll_fwd_cta_rows(k * b, h)}")
                if tag == "train":
                    main[name] = dict(t, bound_ms=bound, bound_by=by,
                                      fp32_cuda_core_bound_ms=cc)
        print(fwd_line, flush=True)
        print(bwd_line, flush=True)
        del h1, w, bias, x, g, got, want, grads, again, want_g
    records = []
    for name, line, worst in (("fwd", 206, worst_f), ("bwd", 242, worst_b)):
        records.append({
            "name": f"fused_ll_{name}", "route": "cuda",
            "source": f"iwae_replication_project_tpu_torch/csrc/"
                      f"fused_ll_{name}.cu",
            "replaces": f"iwae_replication_project_tpu/ops/"
                        f"fused_likelihood.py:{line}",
            "launches": None, "max_abs_err": worst, **main[name],
            "library_ms": None,
            "bound_share": main[name]["bound_ms"] / main[name]["ms"]})
    return records, ok


def fused_ll_path(torch, fl, hot_loop):
    """Phase 3d: the op's path. ``fused_bernoulli_ll`` forward and backward
    on the flagship's last layer at the train shape (fp32, y2 from plain
    torch through the output block's first two layers), with its launches
    counted; held against B1 on the same h1 and against B2's dW3 and db3 for
    the same cotangent. Returns ({kernel: launches}, ok)."""
    h1, w1, b1, w2, b2, w3, b3, x = hot_loop_inputs(
        torch, TRAIN_K, TRAIN_B, seed=400, **FLAGSHIP)
    g = torch.randn((TRAIN_K, TRAIN_B), generator=torch.Generator()
                    .manual_seed(401)).cuda()
    y2 = torch.tanh(torch.tanh(h1 @ w1 + b1) @ w2 + b2)
    leaves = [t.clone().requires_grad_(True) for t in (y2, w3, b3)]
    fl.reset_launch_counts()
    out = fl.fused_bernoulli_ll(*leaves, x)
    grads = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    launches = fl.launch_counts()
    whole = hot_loop.fused_forward(h1, w1, b1, w2, b2, w3, b3, x)
    block = hot_loop.fused_backward(h1, w1, b1, w2, b2, w3, b3, x, g)
    torch.cuda.synchronize()
    err = (out.detach() - whole).abs()
    fwd_ok = bool((err <= FLL_TOL[0] + FLL_TOL[1] * whole.abs()).all())
    parts, bwd_ok = [], True
    for name, a, ref in (("dW", grads[1], block[5]), ("db", grads[2],
                                                      block[6])):
        e = float((a - ref).abs().max())
        scale = max(float(ref.abs().max()), 1e-12)
        bwd_ok &= e <= FLL_BWD_TOL * scale + 1e-6
        parts.append(f"{name} vs B2's {name}3 abs={e:.2e} of_max="
                     f"{e / scale:.1e}")
    launch_ok = launches == {fl.KERNEL_FWD: 1, fl.KERNEL_BWD: 1}
    print(f"op fused_bernoulli_ll fp32 k={TRAIN_K} B={TRAIN_B} H=200 D=784: "
          f"launches {launches} vs B1 max_abs_err={float(err.max()):.3e} "
          f"tol=({FLL_TOL[0]:g} + {FLL_TOL[1]:g}*|ref|); "
          + "; ".join(parts) + f" tol={FLL_BWD_TOL:g}*max|ref| "
          f"{'ok' if fwd_ok and bwd_ok and launch_ok else 'FAIL'}",
          flush=True)
    return launches, fwd_ok and bwd_ok and launch_ok


def eval_b1_launches(cfg, n_test: int, diagnostics: bool) -> int:
    """B1 launches of one ``training_statistics`` run on `n_test` rows (and
    of the estimator diagnostics), derived from the config: per eval batch
    one for the batch metrics and nll_k/chunk for the streamed NLL, then
    nll_k/chunk for the pruned NLL; with diagnostics one more per batch.
    The reconstruction loss and the activity estimate do not reach B1."""
    from iwae_replication_project_tpu_torch.utils.sizes import (
        largest_divisor_leq)
    batch = largest_divisor_leq(n_test, min(cfg.eval_batch_size, n_test))
    chunks = cfg.nll_k // largest_divisor_leq(cfg.nll_k, cfg.nll_chunk)
    n_batches = n_test // batch
    return n_batches * (1 + chunks) + chunks + \
        (n_batches if diagnostics else 0)


def step_breakdown(torch, state, cfg, spec, x, hot_loop):
    """CUDA-event times of one train step at the train shape and of its
    parts: the B1 and B2 kernels and the Adam update each timed alone on the
    step's own tensors; the rest (encoder, prior, their backward, the bound)
    is the step minus those three."""
    from iwae_replication_project_tpu_torch.models import iwae as model
    from iwae_replication_project_tpu_torch.training import train_step as ts

    step = ts.make_train_step(spec, cfg)
    step_ms = time_ms(lambda: step(state, x), torch, iters=10)
    with torch.no_grad():
        h, _, _ = model.encode(state.params, cfg, x, spec.k,
                               generator=state.generator)
    out = state.params["out"]
    w = [out["l1"]["w"], out["l1"]["b"], out["l2"]["w"], out["l2"]["b"],
         out["out"]["w"], out["out"]["b"]]
    w = [t.detach() for t in w]
    h1 = h[0].contiguous()
    g = torch.full((spec.k, x.shape[0]), 1.0 / x.shape[0], device=x.device)
    cd = cfg.matmul_dtype
    fwd_ms = time_ms(lambda: hot_loop.fused_forward(h1, *w, x, cd), torch,
                     iters=10)
    bwd_ms = time_ms(lambda: hot_loop.fused_backward(h1, *w, x, g, cd), torch,
                     iters=10)
    for p in state.optimizer.param_groups[0]["params"]:
        p.grad.zero_()  # the state's static buffers: a graph reads them
    adam_ms = time_ms(lambda: state.optimizer.step(), torch, iters=10)
    return step_ms, fwd_ms, bwd_ms, adam_ms


def train(torch, np, zoo, hot_loop):
    """Phase 5: the flagship preset trained at full width through the
    kernels, evaluated after each stage. Returns ({kernel: launches during
    the run}, the trained state, ok)."""
    import dataclasses

    from iwae_replication_project_tpu_torch.data import load_dataset
    from iwae_replication_project_tpu_torch.models.iwae import ModelConfig
    from iwae_replication_project_tpu_torch.objectives import (
        ObjectiveSpec, objective_value_and_grad)
    from iwae_replication_project_tpu_torch.training import train_step as ts
    from iwae_replication_project_tpu_torch.utils.tree import tree_leaves

    hot_loop.reset_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        state, history = zoo.train(PRESET, n_stages=2, log_dir=tmp + "/runs",
                                   checkpoint_dir=tmp + "/ckpt")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hot_loop.launch_counts()
    graphs = [c for e in state.graphs.values() for c in e.steps.values()]
    captured = sum(len(c.launches) > 0 for c in graphs)
    print(f"train: {len(graphs)} CUDA graph(s) of the step captured, "
          f"{captured} holding kernel launches", flush=True)
    if not state.graphs:
        print("FAIL: the training run did not replay a captured step")
        return launches, state, False
    ok = True
    losses = [v for h in history for v in h["pass_losses"]]
    steps = state.step
    for h in history:
        print(f"train: stage {h['stage']} lr={h['learning_rate']:.2e} "
              f"{h['objective']} k={h['k']} passes={h['passes']} "
              f"steps={h['steps']} pass_losses="
              f"{[round(v, 4) for v in h['pass_losses']]} "
              f"train_s={h['stage_train_seconds']:.3f} "
              f"grad_snr_enc={h.get('diag/grad_snr_enc', float('nan')):.4f} "
              f"grad_snr_dec={h.get('diag/grad_snr_dec', float('nan')):.4f}",
              flush=True)
        print(f"train: stage {h['stage']} eval (eval_batch="
              f"{h['eval_batch']:g}, nll_chunk={h['nll_chunk']:g}, "
              f"kernel_path={h['kernel_path']:g}): "
              + " ".join(f"{n}={h[n]:.4f}" for n in SCALARS + ("LL_pruned",))
              + f" active={h['number_of_active_units']} "
              f"pca_active={h['number_of_PCA_active_units']} "
              f"ess={h['diag/ess']:.3f} eval_s={h['stage_eval_seconds']:.3f}",
              flush=True)
    last = history[-1]
    per_step_host = last["stage_train_seconds"] / (last["steps"]
                                                   - history[-2]["steps"])
    print(f"train: {steps} steps in {wall:.3f}s (zoo.train, data and state "
          f"set-up and the per-stage evaluation included); ms per step over "
          f"stage {last['stage']} (host clock, {last['passes']} passes, one "
          f"fetch) = {per_step_host * 1e3:.4f}", flush=True)
    cfg = zoo.get(PRESET)
    ds = load_dataset(cfg.dataset, data_dir=cfg.data_dir)
    per_eval = eval_b1_launches(cfg, len(ds.x_test), diagnostics=True)
    want_b1 = steps + len(history) * per_eval
    print(f"train: launches during the run {launches} (steps={steps}; B1 "
          f"expected {steps} + {len(history)} stages x {per_eval} eval "
          f"launches = {want_b1}; B2 expected {steps})", flush=True)
    if not (launches[hot_loop.KERNEL] == want_b1
            and launches[hot_loop.KERNEL_BWD] == steps):
        ok = False
        print("FAIL: B1 must launch once per train step plus the eval "
              "count, B2 once per train step and never in eval")
    scalars_ok = all(np.isfinite(h[n]) for h in history
                     for n in SCALARS + ("LL_pruned",))
    ok &= scalars_ok
    finite = bool(np.isfinite(losses).all())
    falling = losses[-1] < losses[0]
    print(f"train: losses finite={finite} first={losses[0]:.4f} "
          f"last={losses[-1]:.4f} falling={falling}", flush=True)
    ok &= finite and falling

    # one step's time and its parts, on the trained state
    model_cfg = cfg.model_config("cuda")
    x = torch.as_tensor(ds.x_train[:TRAIN_B], dtype=torch.float32).cuda()
    spec = cfg.objective_spec(1)
    step_ms, fwd_ms, bwd_ms, adam_ms = step_breakdown(
        torch, state, model_cfg, spec, x, hot_loop)
    rest = step_ms - fwd_ms - bwd_ms - adam_ms
    print(f"train: one step k={spec.k} B={TRAIN_B} bf16 = {step_ms:.4f} ms "
          f"(CUDA events, mean of 10): hot_loop_fwd {fwd_ms:.4f} ms, "
          f"hot_loop_bwd {bwd_ms:.4f} ms, Adam {adam_ms:.4f} ms, rest "
          f"(encoder, prior, their backward, bound) {rest:.4f} ms",
          flush=True)

    # step 1's gradients through the kernels vs the reference path
    fresh = ts.create_train_state(cfg.seed, model_cfg,
                                  output_bias=ds.output_bias)
    gen = torch.Generator().manual_seed(7)
    eps = [torch.randn((spec.k, TRAIN_B, d), generator=gen).cuda()
           for d in model_cfg.n_latent_enc]
    ref_cfg = dataclasses.replace(model_cfg, hot_loop_path="reference")
    _, got = objective_value_and_grad(spec, fresh.params, model_cfg, x,
                                      eps=eps)
    _, want = objective_value_and_grad(spec, fresh.params, ref_cfg, x,
                                       eps=eps)
    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        worst = max(worst, float((a - b).abs().max())
                    / max(float(b.abs().max()), 1e-12))
    within = worst <= GRAD_TOL
    print(f"train: step-1 gradients vs hot_loop_path=reference, "
          f"{len(tree_leaves(got))} leaves: worst max_abs_err/max|ref| = "
          f"{worst:.3e} tol={GRAD_TOL:g} "
          f"{'ok' if within else 'OUT OF TOLERANCE'}", flush=True)
    ok &= within

    # one DReG step at 1-layer width: the backward kernel runs twice
    cfg1 = ModelConfig.one_layer(likelihood="logits",
                                 compute_dtype="bfloat16",
                                 fused_likelihood=True)
    st1 = ts.create_train_state(0, cfg1, output_bias=ds.output_bias)
    dreg = ts.make_train_step(ObjectiveSpec(name="DReG", k=TRAIN_K), cfg1)
    hot_loop.reset_launch_counts()
    st1, metrics = dreg(st1, x)
    torch.cuda.synchronize()
    dreg_launches = hot_loop.launch_counts()
    dreg_ok = dreg_launches == {hot_loop.KERNEL: 1, hot_loop.KERNEL_BWD: 2} \
        and bool(torch.isfinite(metrics["loss"]))
    print(f"train: DReG step at 1-layer width (H1=50, hidden=200) loss="
          f"{float(metrics['loss']):.4f} launches {dreg_launches} "
          f"{'ok' if dreg_ok else 'FAIL: expected 1 forward, 2 backward'}",
          flush=True)
    return launches, state, ok and dreg_ok and scalars_ok


def graph_vs_eager(torch, zoo, hot_loop):
    """Phase 5b: the train step replayed from its CUDA graph against the
    same step run eagerly, on two states made from one seed: bitwise equal
    parameters, Adam moments and step counts, generator and losses after
    every pass, and each path's ms per step (CUDA events around a pass of
    10 steps, mean of 3 passes after one warm pass). Returns (ok, eager ms,
    graph ms)."""
    from iwae_replication_project_tpu_torch.data import load_dataset
    from iwae_replication_project_tpu_torch.training import epoch as te
    from iwae_replication_project_tpu_torch.training import train_step as ts
    from iwae_replication_project_tpu_torch.utils.tree import tree_leaves

    cfg = zoo.get(PRESET)
    model_cfg = cfg.model_config("cuda")
    ds = load_dataset(cfg.dataset, data_dir=cfg.data_dir)
    n = len(ds.x_train) // TRAIN_B * TRAIN_B
    x = torch.as_tensor(ds.x_train[:n].reshape(n, -1),
                        dtype=torch.float32).cuda()
    spec = cfg.objective_spec(1)
    fns = [te.make_epoch_fn(spec, model_cfg, n, TRAIN_B,
                            diagnostics=cfg.diagnostics_config(),
                            cuda_graph=g) for g in (False, True)]
    states = [ts.create_train_state(cfg.seed, model_cfg,
                                    output_bias=ds.output_bias)
              for _ in fns]

    def same():
        a, b = states
        tensors = [(p.detach(), q.detach()) for p, q in
                   zip(tree_leaves(a.params), tree_leaves(b.params))]
        for p, q in zip(tree_leaves(a.params), tree_leaves(b.params)):
            tensors += [(a.optimizer.state[p][k], b.optimizer.state[q][k])
                        for k in ("exp_avg", "exp_avg_sq", "step")]
        return all(torch.equal(u, v) for u, v in tensors) and \
            torch.equal(a.generator.get_state(), b.generator.get_state()) \
            and a.step == b.step

    ok, ms = True, [0.0, 0.0]
    for rep in range(4):
        outs = []
        for i, fn in enumerate(fns):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            states[i], out = fn(states[i], x)
            end.record()
            torch.cuda.synchronize()
            outs.append(out[0])
            if rep:
                ms[i] += start.elapsed_time(end) / (3 * (n // TRAIN_B))
        ok &= same() and torch.equal(*outs)
    print(f"train: graph replay vs eager, 4 passes of {n // TRAIN_B} steps "
          f"k={spec.k} B={TRAIN_B} bf16 with diagnostics: params, Adam "
          f"moments and steps, generator and losses bitwise equal: {ok}; "
          f"ms per step (CUDA events over a pass, mean of 3 after a warm "
          f"pass) eager {ms[0]:.4f}, graph {ms[1]:.4f}", flush=True)
    return ok, ms[0], ms[1]


def wide_block(torch, np, hot_loop):
    """Phase 5c (C5): a bf16 model with a 256-wide output block, which B1's
    and B2's register budgets refuse, trains one pass and scores through the
    reference path: no kernel launch, ``kernel_path/reference`` recorded,
    while the flagship's widths still take the kernels. Returns ok."""
    from iwae_replication_project_tpu_torch.serving.engine import (
        ServingEngine)
    from iwae_replication_project_tpu_torch.training import epoch as te
    from iwae_replication_project_tpu_torch.training import train_step as ts
    from iwae_replication_project_tpu_torch.utils.config import (
        ExperimentConfig)

    cfg = ExperimentConfig(n_hidden_decoder=(100, 256))
    model_cfg = cfg.model_config("cuda")
    why = hot_loop.block_refusal(hot_loop.library_limits(100, 256, True))
    before = hot_loop.path_counters().get("reference", 0)
    x = (torch.rand((3 * TRAIN_B, 784),
                    generator=torch.Generator().manual_seed(3))
         > 0.5).float().cuda()
    hot_loop.reset_launch_counts()
    fn = te.make_epoch_fn(cfg.objective_spec(1), model_cfg, 3 * TRAIN_B,
                          TRAIN_B)
    state = ts.create_train_state(0, model_cfg)
    state, losses = fn(state, x)
    eng = ServingEngine(params=state.params, model_config=model_cfg,
                        k=TRAIN_K, timeout_s=None)
    scores = eng.score(x[:5].cpu().numpy())
    torch.cuda.synchronize()
    launches = hot_loop.launch_counts()
    refs = hot_loop.path_counters().get("reference", 0) - before
    flagship = hot_loop.select_path(torch.device("cuda"),
                                    widths=(100, 200, True))
    ok = (why is not None and launches == {hot_loop.KERNEL: 0,
                                           hot_loop.KERNEL_BWD: 0}
          and refs > 0 and flagship == "kernel"
          and bool(torch.isfinite(losses).all())
          and bool(np.isfinite(scores).all()))
    print(f"c5: bf16 output block 100->(256, 256)->784: refused ({why}); "
          f"one pass of 3 steps and a 5-row score through kernel_path/"
          f"reference ({refs} selections), launches {launches}; the "
          f"flagship's widths take the {flagship} path "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def driver(torch, np, zoo, hot_loop, tmp):
    """Phase 7: the staged driver on the card, ``run_experiment`` of the
    flagship with checkpoints under `tmp` (a temporary directory) and
    PASS_BLOCK=3:
    an uninterrupted 3-stage run; a run with a save every 2 passes whose
    ``sigterm`` fault point after stage 3's first block is absorbed into a
    mid-stage checkpoint and ``TrainingPreempted``; its resume, bitwise
    equal to the uninterrupted run. Launches over the three runs: B2 once
    per step, B1 once per step plus each stage evaluation's count. Then the
    host ms per step over one dispatch of 27 passes (the real PASS_BLOCK)
    on the trained state. Returns ({kernel: launches}, ok, the checkpoint
    run directory of the uninterrupted run)."""
    import dataclasses
    import io
    from contextlib import redirect_stdout

    import iwae_replication_project_tpu_torch.experiment as exp
    from iwae_replication_project_tpu_torch.data import load_dataset
    from iwae_replication_project_tpu_torch.utils import faults
    from iwae_replication_project_tpu_torch.utils.tree import tree_leaves

    block, real_block = 3, exp.PASS_BLOCK
    exp.PASS_BLOCK = block
    base = zoo.get(PRESET)
    ok = True
    hot_loop.reset_launch_counts()

    def cfg(sub, **kw):
        return dataclasses.replace(base, n_stages=3,
                                   log_dir=f"{tmp}/driver/{sub}/runs",
                                   checkpoint_dir=f"{tmp}/driver/{sub}/ckpt",
                                   **kw)
    t0 = time.perf_counter()
    cfg_a = cfg("A", resume=False)
    state_a, hist_a = exp.run_experiment(cfg_a)
    wall_a = time.perf_counter() - t0
    cfg_b = cfg("B", checkpoint_every_passes=2)
    rule = faults.FaultRule(
        faults.SITE_TRAIN_PASS, faults.sigterm(),
        match=lambda c: c["stage"] == 3 and c["done"] == block)
    preempted = None
    with faults.installed(faults.FaultSchedule([rule])):
        try:
            exp.run_experiment(cfg_b)
        except exp.TrainingPreempted as e:
            preempted = e
    buf = io.StringIO()
    with redirect_stdout(buf):
        state_b, hist_b = exp.run_experiment(cfg_b)
    print(buf.getvalue(), end="", flush=True)
    steps_b = state_b.step
    exp.PASS_BLOCK = real_block
    torch.cuda.synchronize()
    launches = hot_loop.launch_counts()

    pairs = [(p.detach(), q.detach()) for p, q in
             zip(tree_leaves(state_a.params), tree_leaves(state_b.params))]
    for p, q in zip(tree_leaves(state_a.params), tree_leaves(state_b.params)):
        pairs += [(state_a.optimizer.state[p][k],
                   state_b.optimizer.state[q][k])
                  for k in ("exp_avg", "exp_avg_sq", "step")]
    bitwise = all(torch.equal(u, v) for u, v in pairs) and torch.equal(
        state_a.generator.get_state(), state_b.generator.get_state())
    resumed = f"continuing at stage 3, pass {block + 1}" in buf.getvalue()
    ok &= preempted is not None and resumed and bitwise \
        and hist_a[-1]["NLL"] == hist_b[-1]["NLL"]
    print(f"driver: uninterrupted 3 stages ({state_a.step} steps, "
          f"PASS_BLOCK={block}) in {wall_a:.3f}s; preempted by a sigterm "
          f"fault point: {preempted}; resumed at stage 3, pass {block + 1}: "
          f"{resumed}; final params, Adam moments and steps, generator "
          f"bitwise equal to the uninterrupted run: {bitwise}; NLL "
          f"{hist_a[-1]['NLL']:.4f} vs {hist_b[-1]['NLL']:.4f}", flush=True)
    prev = 0
    for h in hist_a:
        per_step = h["stage_train_seconds"] / (h["steps"] - prev) * 1e3
        prev = h["steps"]
        print(f"driver: stage {h['stage']} {h['passes']} passes "
              f"({h['passes'] // block} dispatches of {block} + "
              f"{h['passes'] % block} single) host ms per step "
              f"{per_step:.4f} (host clock over the stage, one fetch)",
              flush=True)

    # launches: the killed run and its resume together ran the steps of
    # the uninterrupted one; B evaluated the stages before the kill
    ds = load_dataset(base.dataset, data_dir=base.data_dir)
    per_eval = eval_b1_launches(base, len(ds.x_test), diagnostics=True)
    steps = state_a.step + steps_b
    evals = len(hist_a) + len(hist_b) + (preempted.stage - 1 if preempted
                                         else 0)
    want = {hot_loop.KERNEL: steps + evals * per_eval,
            hot_loop.KERNEL_BWD: steps}
    launch_ok = launches == want
    print(f"driver: launches over the three runs {launches} (expected "
          f"{want}: {steps} steps, {evals} stage evaluations of {per_eval}) "
          f"{'ok' if launch_ok else 'FAIL'}", flush=True)
    ok &= launch_ok

    # one dispatch of the real PASS_BLOCK on the trained state
    from iwae_replication_project_tpu_torch.training import epoch as te
    model_cfg = base.model_config("cuda")
    n = len(ds.x_train) // TRAIN_B * TRAIN_B
    x = torch.as_tensor(ds.x_train[:n].reshape(n, -1),
                        dtype=torch.float32).cuda()
    fn = te.make_epoch_fn(base.objective_spec(3), model_cfg, n, TRAIN_B,
                          diagnostics=base.diagnostics_config(),
                          epochs_per_call=real_block)
    state_a, _ = fn(state_a, x)  # captures this function's graph
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state_a, (out, _) = fn(state_a, x)
    out.cpu()
    block_ms = (time.perf_counter() - t0) * 1e3 / (real_block * n // TRAIN_B)
    print(f"driver: one dispatch of PASS_BLOCK={real_block} passes "
          f"({real_block * n // TRAIN_B} steps, one fetch): host ms per "
          f"step {block_ms:.4f}", flush=True)
    ok &= bool(torch.isfinite(out).all())
    return launches, ok, os.path.join(cfg_a.checkpoint_dir, cfg_a.run_name())



def evaluate(torch, np, zoo, hot_loop, state, b1_eval_ms):
    """Phase 6: the trained flagship evaluated at full width. Returns ok."""
    import dataclasses

    from iwae_replication_project_tpu_torch.data import load_dataset
    from iwae_replication_project_tpu_torch.evaluation import metrics as em
    from iwae_replication_project_tpu_torch.telemetry.diagnostics import (
        estimator_diagnostics)

    cfg = zoo.get(PRESET)
    model_cfg = cfg.model_config("cuda")
    diag_cfg = cfg.diagnostics_config()
    ds = load_dataset(cfg.dataset, data_dir=cfg.data_dir,
                      synthetic_sizes=(1024, EVAL_ROWS))
    x = torch.as_tensor(ds.x_test[:EVAL_ROWS].reshape(EVAL_ROWS, -1),
                        dtype=torch.float32).cuda()
    hot_loop.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, res2 = em.training_statistics(
        state.params, model_cfg, x, cfg.eval_k,
        batch_size=cfg.eval_batch_size, nll_k=cfg.nll_k,
        nll_chunk=cfg.nll_chunk, activity_samples=cfg.activity_samples,
        generator=em.eval_generator(cfg.seed, 1, "cuda"))
    suite_s = time.perf_counter() - t0  # ends in the suite's one fetch
    t0 = time.perf_counter()
    batch = int(res["eval_batch"])
    diag = estimator_diagnostics(
        state.params, model_cfg, x.reshape(EVAL_ROWS // batch, batch, -1),
        cfg.eval_k, diag_cfg, generator=em.eval_generator(cfg.seed, 30_001,
                                                          "cuda"))
    diag = {key: float(v) for key, v in diag.items()}
    diag_s = time.perf_counter() - t0
    launches = hot_loop.launch_counts()
    want_b1 = eval_b1_launches(cfg, EVAL_ROWS, diagnostics=True)
    print(f"eval: training_statistics on {EVAL_ROWS} synthetic test rows, "
          f"eval_k={cfg.eval_k} nll_k={cfg.nll_k} nll_chunk="
          f"{res['nll_chunk']:g} eval_batch={batch} activity_samples="
          f"{cfg.activity_samples} kernel_path={res['kernel_path']:g}: "
          + " ".join(f"{n}={res[n]:.4f}" for n in SCALARS + ("LL_pruned",)),
          flush=True)
    print(f"eval: active units {res2['number_of_active_units']}, PCA active "
          f"{res2['number_of_PCA_active_units']}; diagnostics "
          + " ".join(f"{k.split('/')[1]}={v:.4f}" for k, v in diag.items()),
          flush=True)
    ok = True
    finite = all(np.isfinite(res[n]) for n in SCALARS + ("LL_pruned",))
    # the k=5000 bound is the tighter one: NLL <= -IWAE(k=50), up to the
    # noise of two independent estimates over 1000 rows
    tighter = res["NLL"] <= -res["IWAE"] + 0.5
    launch_ok = launches == {hot_loop.KERNEL: want_b1,
                             hot_loop.KERNEL_BWD: 0}
    print(f"eval: scalars finite={finite} NLL<=-IWAE(k=50)+0.5: {tighter}; "
          f"launches {launches} (B1 expected {EVAL_ROWS // batch} batches x "
          f"(1 + {cfg.nll_k // int(res['nll_chunk'])}) + "
          f"{cfg.nll_k // int(res['nll_chunk'])} pruned + "
          f"{EVAL_ROWS // batch} diagnostics = {want_b1}; B2 expected 0) "
          f"{'ok' if launch_ok else 'FAIL'}", flush=True)
    ok &= finite and tighter and launch_ok

    # one k=5000 NLL batch: its time, B1's share, and the reference path
    xb = x[:batch]
    chunk = int(res["nll_chunk"])
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nll = float(em.streaming_nll(
            state.params, model_cfg, xb, cfg.nll_k, chunk,
            generator=torch.Generator(device="cuda").manual_seed(NLL_SEED)))
        times.append(time.perf_counter() - t0)
    batch_ms = float(np.median(times)) * 1e3
    b1_share = (cfg.nll_k // chunk) * b1_eval_ms / batch_ms
    print(f"eval: whole suite {suite_s:.3f}s + estimator diagnostics "
          f"{diag_s:.3f}s (host clock, each ending in its one fetch); one "
          f"k={cfg.nll_k} NLL batch of {batch} rows = {batch_ms:.3f} ms "
          f"(host clock, median of 3), of which B1 {cfg.nll_k // chunk} x "
          f"{b1_eval_ms:.4f} ms (phase 3, CUDA events, calls back to back) "
          f"= {b1_share:.1%}",
          flush=True)
    ref_cfg = dataclasses.replace(model_cfg, hot_loop_path="reference")
    nll_ref = float(em.streaming_nll(
        state.params, ref_cfg, xb, cfg.nll_k, chunk,
        generator=torch.Generator(device="cuda").manual_seed(NLL_SEED)))
    atol, rtol = NLL_TOL
    within = abs(nll - nll_ref) <= atol + rtol * abs(nll_ref)
    print(f"eval: one batch's NLL through the kernel {nll:.5f} vs "
          f"hot_loop_path=reference {nll_ref:.5f} on the same generator "
          f"seed: |diff|={abs(nll - nll_ref):.3e} tol=({atol:g} + "
          f"{rtol:g}*|ref|) {'ok' if within else 'OUT OF TOLERANCE'}",
          flush=True)
    return ok and within


def _state_tensors(state):
    """Every tensor and generator state of a rank's train state, in a fixed
    order: parameters, Adam moments and steps, the generator, the streams."""
    from iwae_replication_project_tpu_torch.utils.tree import tree_leaves
    out = [p.detach() for p in tree_leaves(state.params)]
    for p in tree_leaves(state.params):
        out += [state.optimizer.state[p][k]
                for k in ("exp_avg", "exp_avg_sq", "step")]
    out.append(state.generator.get_state())
    out += [state.streams[k].get_state() for k in sorted(state.streams)]
    return out


def parallel_nccl(torch, np, zoo, hot_loop, tmp):
    """Phase 8a: an NCCL world of one process on mesh (1, 1), the flagship
    preset: the parallel epoch replayed from its CUDA graph (the
    all_reduce captured in it) against the same passes run eagerly, bitwise
    in parameters, Adam moments, generators and losses, with the launches
    of B1 and B2 exact across the replays; then one pass on injected draws
    against the single-device epoch on the same draws, bitwise. Returns
    ({kernel: launches of the graph passes}, ok)."""
    from iwae_replication_project_tpu_torch.data import load_dataset
    from iwae_replication_project_tpu_torch.parallel import dp as pdp
    from iwae_replication_project_tpu_torch.parallel import (
        make_mesh, multihost)
    from iwae_replication_project_tpu_torch.training import epoch as te
    from iwae_replication_project_tpu_torch.training import train_step as ts

    cfg = zoo.get(PRESET)
    model_cfg = cfg.model_config("cuda")
    spec = cfg.objective_spec(1)
    diag = cfg.diagnostics_config()
    ds = load_dataset(cfg.dataset, data_dir=cfg.data_dir)
    n = len(ds.x_train) // TRAIN_B * TRAIN_B
    x = torch.as_tensor(ds.x_train[:n].reshape(n, -1),
                        dtype=torch.float32).cuda()
    steps = n // TRAIN_B
    info = multihost.initialize(f"file://{tmp}/nccl-rendezvous", 1, 0,
                                device="cuda")
    try:
        mesh = make_mesh(1, 1, device="cuda")
        print(f"parallel: NCCL world {info}, mesh (dp, sp) = "
              f"({mesh.dp}, {mesh.sp}), backend {mesh.backend}", flush=True)

        def fresh():
            return pdp.parallel_train_state(mesh, ts.create_train_state(
                cfg.seed, model_cfg, output_bias=ds.output_bias))

        fns = [pdp.make_parallel_epoch_fn(spec, model_cfg, mesh, n, TRAIN_B,
                                          diagnostics=diag, cuda_graph=g)
               for g in (False, True)]
        states = [fresh(), fresh()]
        ok, ms = True, [0.0, 0.0]
        launches = [{}, {}]
        for rep in range(4):
            outs = []
            for i, fn in enumerate(fns):
                hot_loop.reset_launch_counts()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                states[i], out = fn(states[i], x)
                end.record()
                torch.cuda.synchronize()
                got = hot_loop.launch_counts()
                for k_, v in got.items():
                    launches[i][k_] = launches[i].get(k_, 0) + v
                ok &= got == {hot_loop.KERNEL: steps,
                              hot_loop.KERNEL_BWD: steps}
                outs.append(out[0])
                if rep:
                    ms[i] += start.elapsed_time(end) / (3 * steps)
            ok &= torch.equal(*outs) and all(
                torch.equal(a, b) for a, b in zip(
                    _state_tensors(states[0]), _state_tensors(states[1])))
        graphs = sum(len(e.steps) for e in states[1].graphs.values())
        ok &= graphs > 0 and not states[0].graphs
        print(f"parallel: NCCL (1, 1) graph replay vs eager, 4 passes of "
              f"{steps} steps k={spec.k} B={TRAIN_B} bf16 with diagnostics "
              f"({graphs} captured step graph(s), all_reduce inside): "
              f"params, Adam moments, generators and losses bitwise equal, "
              f"launches B1 = B2 = {steps} per pass on both paths: {ok}; "
              f"launches {launches[1]} (graph) {launches[0]} (eager); ms "
              f"per step (CUDA events over a pass, mean of 3 after a warm "
              f"pass) eager {ms[0]:.4f}, graph {ms[1]:.4f}", flush=True)

        # injected draws: the mesh of one against the single-device epoch
        g = torch.Generator().manual_seed(17)
        perm = torch.randperm(n, generator=g)
        noise = [[torch.randn((spec.k, TRAIN_B, d), generator=g).cuda()
                  for d in model_cfg.n_latent_enc] for _ in range(steps)]
        single = te.make_epoch_fn(spec, model_cfg, n, TRAIN_B,
                                  diagnostics=diag)
        a, b = fresh(), ts.create_train_state(cfg.seed, model_cfg,
                                              output_bias=ds.output_bias)
        a, out_a = fns[1](a, x, perm=perm, noise=noise)
        b, out_b = single(b, x, perm=perm, noise=noise)
        torch.cuda.synchronize()
        same = torch.equal(out_a[0], out_b[0]) and all(
            torch.equal(u, v) for u, v in zip(_state_tensors(a)[:-3],
                                              _state_tensors(b)[:-1]))
        print(f"parallel: NCCL (1, 1) epoch on injected draws vs the "
              f"single-device epoch, one pass of {steps} steps: losses, "
              f"params and Adam moments bitwise equal: {same}", flush=True)
        return launches[1], ok and same
    finally:
        multihost.shutdown()


def _gloo_rank(rank, world, init, out):
    """One rank of phase 8b (a process of its own; gloo on the one card)."""
    import json as _json

    import torch

    from iwae_replication_project_tpu_torch import zoo
    from iwae_replication_project_tpu_torch.evaluation import metrics as ev
    from iwae_replication_project_tpu_torch.objectives import (
        ObjectiveSpec, objective_value_and_grad)
    from iwae_replication_project_tpu_torch.ops import hot_loop
    from iwae_replication_project_tpu_torch.parallel import dp as pdp
    from iwae_replication_project_tpu_torch.parallel import eval as peval
    from iwae_replication_project_tpu_torch.parallel import (
        make_mesh, multihost)
    from iwae_replication_project_tpu_torch.training import train_step as ts
    from iwae_replication_project_tpu_torch.utils.tree import (
        tree_leaves, tree_map)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    multihost.initialize(init, world, rank, backend="gloo", device=dev)
    res = {"rank": rank}
    try:
        mesh = make_mesh(*GLOO_MESH, device=dev)
        probe = mesh.all_reduce(torch.tensor([float(rank)], device=dev),
                                "max")
        res["max_ok"] = float(probe) == world - 1
        cfg = zoo.get(PRESET)
        model_cfg = cfg.model_config("cuda")
        state = pdp.parallel_train_state(mesh, ts.create_train_state(
            cfg.seed, model_cfg))
        # the steps timed below update the state's parameters in place
        params = tree_map(lambda t: t.detach().clone(), state.params)
        g = torch.Generator().manual_seed(23)
        x = (torch.rand((TRAIN_B, 784), generator=g) > 0.5).float().cuda()
        eps_full = [torch.randn((TRAIN_K, TRAIN_B, d), generator=g).cuda()
                    for d in model_cfg.n_latent_enc]
        b, kl = TRAIN_B // mesh.dp, TRAIN_K // mesh.sp
        rows = slice(mesh.dp_rank * b, (mesh.dp_rank + 1) * b)
        ks = slice(mesh.sp_rank * kl, (mesh.sp_rank + 1) * kl)
        eps = [e[ks, rows].contiguous() for e in eps_full]
        x_local = x[rows]
        hot_loop.reset_launch_counts()
        got = {}
        for name in ("IWAE", "DReG"):
            spec = ObjectiveSpec(name=name, k=TRAIN_K)
            vg = pdp.make_parallel_value_and_grad(spec, model_cfg, mesh,
                                                  TRAIN_B)
            got[name] = vg(params, x_local, eps=eps)
        # ms per step of this rank: the parallel step with Adam, eagerly
        step = pdp.make_parallel_train_step(cfg.objective_spec(1),
                                            model_cfg, mesh, TRAIN_B)
        for _ in range(2):
            state, _ = step(state, x_local)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            state, m = step(state, x_local)
        float(m["loss"])
        res["step_ms"] = (time.perf_counter() - t0) / 5 * 1e3

        # the sharded k=5000 NLL: rows over dp, samples over sp
        xn = (torch.rand((NLL_ROWS, 784), generator=g) > 0.5).float().cuda()
        lat = model_cfg.n_latent_enc

        def chunk(c):
            gc = torch.Generator(device=dev).manual_seed(1000 + c)
            return [torch.randn((NLL_CHUNK, NLL_ROWS, d), generator=gc,
                                device=dev) for d in lat]

        nb = NLL_ROWS // mesh.dp
        nrows = slice(mesh.dp_rank * nb, (mesh.dp_rank + 1) * nb)
        per_rank = NLL_K // mesh.sp // NLL_CHUNK
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        log_px = peval.parallel_streaming_log_px(
            params, model_cfg, mesh, xn[nrows], NLL_K, NLL_CHUNK,
            noise=lambda j: [t[:, nrows].contiguous() for t in
                             chunk(mesh.sp_rank * per_rank + j)])
        total = mesh.all_reduce(log_px.sum().reshape(1), axis="dp")
        nll = -float(total) / NLL_ROWS
        res["nll_ms"] = (time.perf_counter() - t0) * 1e3
        res["nll"] = nll
        res["launches"] = hot_loop.launch_counts()
        res["bounds"] = {k: float(v[0]) for k, v in got.items()}
        if rank == 0:  # the single-process references, not counted
            for name in ("IWAE", "DReG"):
                spec = ObjectiveSpec(name=name, k=TRAIN_K)
                bound, grads = objective_value_and_grad(
                    spec, params, model_cfg, x, eps=eps_full)
                worst = max(float((a - c).abs().max())
                            / max(float(c.abs().max()), 1e-12)
                            for a, c in zip(tree_leaves(got[name][1]),
                                            tree_leaves(grads)))
                res[f"ref_{name}"] = (float(bound), worst)
            res["ref_nll"] = -float(ev.streaming_log_px(
                params, model_cfg, xn, NLL_K, NLL_CHUNK,
                noise=chunk).mean())
        with open(f"{out}/rank{rank}.json", "w") as f:
            _json.dump(res, f)
    finally:
        multihost.shutdown()


def parallel_gloo(torch, np, hot_loop, tmp):
    """Phase 8b: a gloo world of 4 processes on the one card, mesh (2, 2),
    at flagship width: one step's loss and per-leaf gradients for IWAE and
    DReG against the single-process step on the whole batch with the same
    per-shard draws; the sharded k=5000 NLL of 500 rows (2500 samples per
    rank in chunks of 250) against the single-device NLL on the same draws.
    Returns ({kernel: launches summed over the ranks}, ok)."""
    from iwae_replication_project_tpu_torch.parallel import multihost

    world = GLOO_MESH[0] * GLOO_MESH[1]
    t0 = time.perf_counter()
    codes = multihost.spawn(_gloo_rank, world,
                            (f"file://{tmp}/gloo-rendezvous", tmp),
                            timeout=600, grace=30)
    wall = time.perf_counter() - t0
    if codes != [0] * world:
        print(f"FAIL: the gloo ranks exited {codes}", flush=True)
        return {}, False
    ranks = []
    for r in range(world):
        with open(f"{tmp}/rank{r}.json") as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in r0["launches"]}
    ok = all(r["max_ok"] for r in ranks)
    if not ok:
        print("FAIL: gloo's all_reduce on CUDA tensors did not take the MAX")
    same = all(r["bounds"] == r0["bounds"] and r["nll"] == r0["nll"]
               for r in ranks)
    ok &= same
    atol, _ = TOL["bf16"]
    for name in ("IWAE", "DReG"):
        want, worst = r0[f"ref_{name}"]
        err = abs(-r0["bounds"][name] + want)
        fine = err <= atol and worst <= GRAD_TOL
        ok &= fine
        print(f"parallel: gloo {GLOO_MESH} one {name} step k={TRAIN_K} "
              f"B={TRAIN_B} bf16 (each rank k={TRAIN_K // GLOO_MESH[1]} x "
              f"B={TRAIN_B // GLOO_MESH[0]}) vs the single-process step on "
              f"the same draws: bound abs err {err:.3e} (tol {atol:g}), "
              f"worst per-leaf max_abs_err/max|ref| {worst:.3e} (tol "
              f"{GRAD_TOL:g}) {'ok' if fine else 'OUT OF TOLERANCE'}",
              flush=True)
    nll_err = abs(r0["nll"] - r0["ref_nll"])
    nll_ok = nll_err <= NLL_TOL[0] + NLL_TOL[1] * abs(r0["ref_nll"])
    ok &= nll_ok
    print(f"parallel: gloo {GLOO_MESH} sharded NLL of {NLL_ROWS} rows, "
          f"k={NLL_K} ({NLL_K // GLOO_MESH[1]} samples per rank, chunk "
          f"{NLL_CHUNK}, B1 at {NLL_CHUNK} x {NLL_ROWS // GLOO_MESH[0]}): "
          f"{r0['nll']:.4f} vs single-device {r0['ref_nll']:.4f} on the "
          f"same draws, abs err {nll_err:.3e} (tol {NLL_TOL[0]:g} + "
          f"{NLL_TOL[1]:g}*|ref|) {'ok' if nll_ok else 'OUT OF TOLERANCE'}; "
          f"every rank the same results: {same}", flush=True)
    print("parallel: gloo per-rank host ms per eager step k=50 B=100 (gloo "
          "copies every collective through the host and 4 ranks share one "
          "card: not speed numbers) "
          + " ".join(f"rank{r['rank']}={r['step_ms']:.2f}" for r in ranks)
          + "; sharded NLL ms per rank "
          + " ".join(f"rank{r['rank']}={r['nll_ms']:.1f}" for r in ranks)
          + f"; world wall {wall:.1f}s", flush=True)
    want_ok = launches.get(hot_loop.KERNEL, 0) > 0 and \
        launches.get(hot_loop.KERNEL_BWD, 0) > 0
    print(f"parallel: gloo launches summed over the ranks {launches} "
          f"{'ok' if want_ok else 'FAIL: a kernel of the path never ran'}",
          flush=True)
    return launches, ok and want_ok


def parallel_cli(np, tmp):
    """Phase 8c: ``python -m iwae_replication_project_tpu_torch --mesh-dp 1
    --mesh-sp 1``, 2 stages of the flagship: one spawned rank on NCCL,
    whose step is the captured graph with its all_reduce. Returns ok."""
    cmd = [sys.executable, "-m", "iwae_replication_project_tpu_torch",
           "--mesh-dp", "1", "--mesh-sp", "1", "--n-stages", "2",
           "--log-dir", f"{tmp}/cli/runs",
           "--checkpoint-dir", f"{tmp}/cli/ckpt"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=str(Path(__file__).resolve().parent))
    wall = time.perf_counter() - t0
    stages = [ln for ln in proc.stdout.splitlines()
              if ln.startswith("stage ")]
    rows = []
    for d in Path(f"{tmp}/cli/runs").glob("*/metrics.jsonl"):
        rows += [json.loads(ln) for ln in d.read_text().splitlines()]
    ok = proc.returncode == 0 and len(stages) == 2 and \
        [r["stage"] for r in rows] == [1.0, 2.0] and \
        all(np.isfinite(r["NLL"]) for r in rows)
    for ln in stages:
        print(f"parallel: cli {ln}", flush=True)
    print(f"parallel: cli --mesh-dp 1 --mesh-sp 1 --n-stages 2 exit "
          f"{proc.returncode} in {wall:.1f}s (spawn, NCCL init, 2 stages and "
          f"their evaluation), {len(rows)} logged rows "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        print(proc.stdout[-2000:], proc.stderr[-4000:], flush=True)
    return ok


def facade(torch, np, hot_loop, tmp):
    """Phase 9: the FlexibleModel facade at the example's architecture on
    the card, at its defaults (clamp likelihood, fp32: no kernel, as the JAX
    facade): compile, fit one epoch, the k=5000 NLL of 100 rows and the
    statistics suite; a save_weights/load_weights round trip, bitwise; one
    epoch with likelihood="logits" and bf16, which runs B1 and B2; then
    ``examples/experiment_example_torch.py --smoke``. Returns ({kernel:
    launches of the logits epoch}, ok)."""
    from iwae_replication_project_tpu_torch.api import FlexibleModel
    from iwae_replication_project_tpu_torch.data import load_dataset
    from iwae_replication_project_tpu_torch.utils.tree import tree_leaves

    arch = ([200, 100], [100, 200], [100, 50], [100, 784])
    ds = load_dataset("binarized_mnist", data_dir="data")
    hot_loop.reset_launch_counts()
    t0 = time.perf_counter()
    mdl = FlexibleModel(*arch, dataset_bias=None, pixel_means=ds.bias_means,
                        loss_function="IWAE", k=TRAIN_K).compile()
    hist = mdl.fit(ds.x_train, epochs=1, batch_size=TRAIN_B,
                   binarization=ds.binarization)
    nll = float(mdl.get_NLL(ds.x_test[:100], k=5000))
    res, res2 = mdl.get_training_statistics(ds.x_test[:100], TRAIN_K)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    none = hot_loop.launch_counts()
    ok = none == {hot_loop.KERNEL: 0, hot_loop.KERNEL_BWD: 0} and \
        np.isfinite(hist["loss"][0]) and np.isfinite(nll) and \
        all(np.isfinite(res[n]) for n in SCALARS)
    print(f"facade: defaults (clamp, fp32) compile + fit 1 epoch "
          f"(loss {hist['loss'][0]:.4f}) + get_NLL k=5000 on 100 rows "
          f"({nll:.4f}) + get_training_statistics (NLL {res['NLL']:.4f}, "
          f"IWAE {res['IWAE']:.4f}, active "
          f"{res2['number_of_active_units']}) in {wall:.1f}s; launches "
          f"{none} (none expected) {'ok' if ok else 'FAIL'}", flush=True)
    path = mdl.save_weights(f"{tmp}/facade_weights")
    other = FlexibleModel(*arch, dataset_bias=None, seed=5).compile()
    other.load_weights(path)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(other.params),
                                                 tree_leaves(mdl.params)))
    ok &= same
    print(f"facade: save_weights/load_weights round trip ({path.split('/')[-1]}"
          f", the JAX facade's .npz) bitwise: {same}", flush=True)
    fast = FlexibleModel(*arch, dataset_bias=None, pixel_means=ds.bias_means,
                         loss_function="IWAE", k=TRAIN_K,
                         likelihood="logits",
                         compute_dtype="bfloat16").compile()
    hot_loop.reset_launch_counts()
    hist = fast.fit(ds.x_train, epochs=1, batch_size=TRAIN_B,
                    binarization=ds.binarization)
    torch.cuda.synchronize()
    launches = hot_loop.launch_counts()
    steps = len(ds.x_train) // TRAIN_B
    fast_ok = launches == {hot_loop.KERNEL: steps,
                           hot_loop.KERNEL_BWD: steps} and \
        np.isfinite(hist["loss"][0])
    ok &= fast_ok
    print(f"facade: likelihood=logits bf16 fit 1 epoch of {steps} steps "
          f"(loss {hist['loss'][0]:.4f}): launches {launches} "
          f"{'ok' if fast_ok else 'FAIL'}", flush=True)
    here = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(here / "examples" / "experiment_example_torch.py"),
         "--smoke", "--out-dir", f"{tmp}/example"], cwd=str(here),
        capture_output=True, text=True, timeout=600)
    ex_ok = proc.returncode == 0 and "done: 2 stages" in proc.stdout
    ok &= ex_ok
    print(f"facade: examples/experiment_example_torch.py --smoke exit "
          f"{proc.returncode} in {time.perf_counter() - t0:.1f}s "
          f"{'ok' if ex_ok else 'FAIL'}", flush=True)
    if not ex_ok:
        print(proc.stdout[-2000:], proc.stderr[-4000:], flush=True)
    return launches, ok


def _padded(np, rows, seeds, bucket):
    """A dispatch's rows and seeds padded to its bucket, as the engine
    pads them."""
    x = np.zeros((bucket, rows.shape[1]), np.float32)
    x[:len(rows)] = rows
    return x, list(seeds) + [0] * (bucket - len(seeds))


def _adaptive_launches(k_used, dp: int, sp: int, kc: int) -> int:
    """B1 launches of one adaptive dispatch over a (dp, sp) mesh, summed
    over the ranks, from its real rows' k_used (rows in dp order, the
    bucket's B/dp a rank; here every dispatch is a whole bucket): per dp
    row, each sp rank runs as many phase-1 rounds as its slowest row needs
    (``max ceil(k_used / (sp*kc))``), then its share of phase 2 (sp rank s
    takes blocks ``s*bpd + i`` of each row, ``bpd = ceil(blocks/sp)``)."""
    total = 0
    b = len(k_used) // dp
    for d in range(dp):
        rows = k_used[d * b:(d + 1) * b]
        blocks = [math.ceil(u / kc) for u in rows]
        rounds = max(math.ceil(u / (sp * kc)) for u in rows)
        for s in range(sp):
            bpd = [math.ceil(n / sp) for n in blocks]
            total += rounds + max(max(0, min(p, n - s * p))
                                  for p, n in zip(bpd, blocks))
    return total


def sharded_serve(torch, np, zoo, hot_loop, run_dir, b1_ms):
    """Phase 10a: the sharded engine on the card from phase 7's run dir, a
    world of one. Returns (B1 launches of the served stream, ok)."""
    import dataclasses

    from iwae_replication_project_tpu_torch.data import load_dataset
    from iwae_replication_project_tpu_torch.parallel import eval as peval
    from iwae_replication_project_tpu_torch.serving.sharded import (
        ShardedScoreEngine)

    kc = SHARDED_KC
    eng = ShardedScoreEngine(run_dir, k_chunk=kc, k_max=SHARDED_KMAX,
                             max_batch=SHARDED_BATCH, timeout_s=None)
    ok = eng.cfg.compute_dtype == "bfloat16" and \
        eng.cfg.likelihood == "logits" and eng.device.type == "cuda"
    ds = load_dataset(zoo.get(PRESET).dataset, data_dir="data")
    data = ds.x_test.reshape(len(ds.x_test), -1).astype(np.float32)
    t0 = time.perf_counter()
    warm = eng.warmup()
    torch.cuda.synchronize()
    print(f"sharded: ShardedScoreEngine({run_dir.split('/')[-1]}) "
          f"k={eng.k} k_chunk={kc} k_max={eng.k_max} "
          f"buckets={list(eng.ladder.buckets)} "
          f"compute_dtype={eng.cfg.compute_dtype} mesh=({eng.mesh.dp}, "
          f"{eng.mesh.sp}) warmup {warm} in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    rec = _Recorder(eng)  # the dispatches, for the launch count
    log = rec.log

    hot_loop.reset_launch_counts()
    eng.start()
    t0 = time.perf_counter()
    score_f, adapt_f, seed, i = [], [], 0, 0
    for k, n in SHARDED_STREAM:
        for _ in range(n):
            score_f.append(eng.submit("score", data[i % len(data)], k=k,
                                      seed=seed))
            i, seed = i + 1, seed + 1
    for tgt in ADAPTIVE_TARGETS:
        for _ in range(SHARDED_BATCH):
            adapt_f.append(eng.submit("score_adaptive", data[i % len(data)],
                                      k=SHARDED_KMAX, seed=seed, **tgt))
            i, seed = i + 1, seed + 1
    scores = np.array([f.result(timeout=600) for f in score_f])
    adaptive = np.stack([f.result(timeout=600) for f in adapt_f])
    wall = time.perf_counter() - t0
    eng.stop()
    torch.cuda.synchronize()
    launches = hot_loop.launch_counts()
    eng._launch = rec._launch

    want = 0
    for inf in log:
        if inf.op == "score":
            want += math.ceil(inf.k / kc)
        else:
            want += _adaptive_launches(
                [float(r.future.result()[2]) for r in inf.batch], 1, 1, kc)
    launch_ok = launches == {hot_loop.KERNEL: want, hot_loop.KERNEL_BWD: 0}
    ok &= launch_ok
    finite = bool(np.isfinite(scores).all() and np.isfinite(adaptive).all())
    ok &= finite
    snap = eng.metrics.snapshot()
    print(f"sharded: {len(score_f)} score requests over (k, rows) groups "
          f"{SHARDED_STREAM} and {len(adapt_f)} score_adaptive at k_cap "
          f"{SHARDED_KMAX} with {ADAPTIVE_TARGETS}: {len(log)} dispatches "
          f"in {wall:.3f}s (host clock), all finite={finite}; kernel stamps "
          f"{sorted(snap['kernel'])}", flush=True)
    print(f"sharded: B1 launches {launches} (expected {want}: ceil(k/{kc}) "
          f"per score dispatch, the rounds run plus max ceil(k_used/{kc}) "
          f"per adaptive one) {'ok' if launch_ok else 'FAIL'}", flush=True)
    for j, tgt in enumerate(ADAPTIVE_TARGETS):
        ku = adaptive[j * SHARDED_BATCH:(j + 1) * SHARDED_BATCH, 2]
        se = adaptive[j * SHARDED_BATCH:(j + 1) * SHARDED_BATCH, 1]
        print(f"sharded: score_adaptive {tgt}: k_used {ku.astype(int)} "
              f"achieved se {np.round(se, 4)}", flush=True)

    # every dispatch against the offline twin on the same padded rows, and
    # each adaptive row against the fixed-k score at its k_used
    same, prefix, rows_checked = True, True, 0
    for inf in log:
        n = len(inf.batch)
        x, seeds = _padded(np, np.stack([r.payload for r in inf.batch]),
                           [r.seed for r in inf.batch], inf.bucket)
        xt = torch.from_numpy(x).cuda()
        got = np.stack([r.future.result() for r in inf.batch])
        if inf.op == "score":
            off = peval.sharded_score_offline(
                eng._params, eng.cfg, eng.mesh, eng._base_seed, seeds, xt,
                inf.k, kc)
            same &= np.array_equal(got, off[:n].cpu().numpy())
            continue
        r0 = inf.batch[0]
        off = peval.sharded_score_adaptive_offline(
            eng._params, eng.cfg, eng.mesh, eng._base_seed, seeds, xt,
            k_cap=inf.k, target_se=r0.target_se, ess_floor=r0.ess_floor,
            k_chunk=kc)
        same &= np.array_equal(got, off[:n].cpu().numpy())
        for u in sorted(set(got[:, 2].astype(int))):
            fixed = peval.sharded_score_offline(
                eng._params, eng.cfg, eng.mesh, eng._base_seed, seeds, xt,
                int(u), kc)[:n].cpu().numpy()
            rows = got[:, 2] == u
            prefix &= np.array_equal(got[rows, 0], fixed[rows])
            rows_checked += int(rows.sum())
    ok &= same and prefix
    print(f"sharded: every dispatch bitwise equal to the offline twin on "
          f"its padded rows: {same}; {rows_checked} adaptive rows bitwise "
          f"equal to the fixed-k score at their k_used: {prefix}",
          flush=True)

    # k=5000 through the kernel against the reference path, bf16 and fp32
    x8 = torch.from_numpy(data[:SHARDED_BATCH]).cuda()
    seeds8 = list(range(SHARDED_BATCH))
    for name, cfg in (("bf16", eng.cfg),
                      ("fp32", dataclasses.replace(eng.cfg,
                                                   compute_dtype=None))):
        got, want_ = (peval.sharded_score_offline(
            eng._params, cfg, eng.mesh, 0, seeds8, x8, SHARDED_KMAX, kc,
            kernel_path=p).cpu().numpy() for p in (None, "reference"))
        atol, rtol = TOL[name]
        err = np.abs(got - want_)
        within = bool((err <= atol + rtol * np.abs(want_)).all())
        ok &= within
        print(f"sharded: k={SHARDED_KMAX} scores of {SHARDED_BATCH} rows "
              f"{name}, kernel vs reference path: max_abs_err="
              f"{err.max():.3e} tol=({atol:g} + {rtol:g}*|ref|) "
              f"{'ok' if within else 'OUT OF TOLERANCE'}", flush=True)

    # the k=5000 dispatch of 8 rows: CUDA events and host clock
    def dispatch():
        return peval.sharded_score_offline(eng._params, eng.cfg, eng.mesh, 0,
                                           seeds8, x8, SHARDED_KMAX, kc)
    dispatch()
    torch.cuda.synchronize()
    host = []
    for _ in range(5):
        t1 = time.perf_counter()
        dispatch()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t1) * 1e3)
    ev_ms = time_ms(dispatch, torch, iters=5)
    blocks = SHARDED_KMAX // kc
    # its parts: the per-row device draws alone, and the program on the
    # same draws drawn beforehand (replayed through noise_fn)
    from iwae_replication_project_tpu_torch.serving.programs import (
        draw_block_noise)
    drawn = {g: draw_block_noise(eng.cfg, 0, seeds8, [g] * SHARDED_BATCH,
                                 kc, x8.device) for g in range(blocks)}
    draw_ms = time_ms(lambda: [draw_block_noise(
        eng.cfg, 0, seeds8, [g] * SHARDED_BATCH, kc, x8.device)
        for g in range(blocks)], torch, iters=5)
    rest_ms = time_ms(lambda: peval.sharded_score_offline(
        eng._params, eng.cfg, eng.mesh, 0, seeds8, x8, SHARDED_KMAX, kc,
        noise_fn=lambda g, s: drawn[g]), torch, iters=5)
    print(f"sharded: one k={SHARDED_KMAX} dispatch of {SHARDED_BATCH} rows "
          f"({blocks} blocks of {kc} x {SHARDED_BATCH}): {ev_ms:.3f} ms "
          f"(CUDA events, 5 back to back), host {np.median(host):.3f} ms "
          f"(median of 5, synchronized); B1 {blocks} x {b1_ms:.4f} ms "
          f"(phase 3, 250 x 8) = {blocks * b1_ms / ev_ms:.1%} of it; "
          f"{SHARDED_BATCH / np.median(host) * 1e3:.1f} rows/s at "
          f"k={SHARDED_KMAX}; its parts (CUDA events, 5 back to back): the "
          f"{blocks} blocks' per-row device draws alone {draw_ms:.3f} ms, "
          f"the program on those draws drawn beforehand {rest_ms:.3f} ms",
          flush=True)
    return launches[hot_loop.KERNEL], ok


def _sharded_rank(rank, world, init, out, run_dir, x, mesh_shape, kill):
    """One rank of phase 10b (a process of its own; gloo on the one card):
    rank 0 serves the sharded engine, the others run serve_rank. With
    `kill`, rank 1 dies on its first dispatch."""
    import json as _json

    import torch

    from iwae_replication_project_tpu_torch.ops import hot_loop
    from iwae_replication_project_tpu_torch.parallel import (
        make_mesh, multihost)
    from iwae_replication_project_tpu_torch.serving.sharded import (
        ShardedScoreEngine, serve_rank)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    multihost.initialize(init, world, rank, backend="gloo", device=dev,
                         timeout=datetime.timedelta(seconds=120))
    res = {"rank": rank}
    try:
        mesh = make_mesh(*mesh_shape, device=dev)
        eng = ShardedScoreEngine(run_dir, mesh=mesh, k_chunk=SHARDED_KC,
                                 k_max=SHARDED_KMAX, max_batch=SHARDED_BATCH,
                                 timeout_s=None)
        hot_loop.reset_launch_counts()
        if rank != 0:
            if kill:
                def die(*a, **kw):
                    os._exit(3)
                eng._program_for = die
            res["served"] = serve_rank(eng)
        else:
            t0 = time.perf_counter()
            fs = [eng.submit("score", r, k=SHARDED_GLOO_K, seed=s)
                  for s, r in enumerate(x)]
            fa = [eng.submit("score_adaptive", r, k=SHARDED_KMAX, seed=s,
                             **ADAPTIVE_TARGETS[0]) for s, r in enumerate(x)]
            eng.start()
            if kill:
                err = fs[0].exception(timeout=300)
                res["error"] = None if err is None else \
                    f"{type(err).__name__}: {str(err)[:200]}"
                res["waited"] = time.perf_counter() - t0
                try:
                    eng.stop()
                except RuntimeError as e:
                    res["stop_error"] = type(e).__name__
            else:
                res["score"] = [float(f.result(timeout=600)) for f in fs]
                res["adaptive"] = [f.result(timeout=600).tolist()
                                   for f in fa]
                res["wall"] = time.perf_counter() - t0
                eng.stop()
        torch.cuda.synchronize()
        res["launches"] = hot_loop.launch_counts()
        with open(f"{out}/sharded-rank{rank}.json", "w") as f:
            _json.dump(res, f)
    finally:
        multihost.shutdown()


def sharded_gloo(torch, np, zoo, hot_loop, run_dir, tmp):
    """Phase 10b: the sharded engine over a gloo world of 4 processes on
    the one card, mesh (2, 2), against the world of one on the same
    per-(row, block) draws (each row's block g is drawn from (engine seed,
    request seed, g) on the card, whichever rank streams it); then a world
    of 2 whose follower dies. Returns ({kernel: launches summed over the
    ranks}, ok)."""
    from iwae_replication_project_tpu_torch.data import load_dataset
    from iwae_replication_project_tpu_torch.parallel import eval as peval
    from iwae_replication_project_tpu_torch.parallel import multihost
    from iwae_replication_project_tpu_torch.serving.sharded import (
        ShardedScoreEngine)

    ds = load_dataset(zoo.get(PRESET).dataset, data_dir="data")
    x = ds.x_test.reshape(len(ds.x_test), -1)[:SHARDED_BATCH].astype(
        np.float32)
    dp, sp = GLOO_MESH
    world = dp * sp
    t0 = time.perf_counter()
    codes = multihost.spawn(
        _sharded_rank, world, (f"file://{tmp}/sharded-rendezvous", tmp,
                               run_dir, x, GLOO_MESH, False),
        timeout=600, grace=30)
    wall = time.perf_counter() - t0
    if codes != [0] * world:
        print(f"FAIL: the sharded gloo ranks exited {codes}", flush=True)
        return {}, False
    ranks = []
    for r in range(world):
        with open(f"{tmp}/sharded-rank{r}.json") as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    served_ok = all(r["served"] == 2 for r in ranks[1:])
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in r0["launches"]}
    ku = [int(a[2]) for a in r0["adaptive"]]
    want = sp * dp * math.ceil(math.ceil(SHARDED_GLOO_K / SHARDED_KC) / sp) \
        + _adaptive_launches(ku, dp, sp, SHARDED_KC)
    launch_ok = launches == {hot_loop.KERNEL: want, hot_loop.KERNEL_BWD: 0}

    # the world of one on the same rows and seeds
    eng = ShardedScoreEngine(run_dir, k_chunk=SHARDED_KC,
                             k_max=SHARDED_KMAX, max_batch=SHARDED_BATCH)
    xt = torch.from_numpy(x).cuda()
    seeds = list(range(SHARDED_BATCH))

    def one(k):
        return peval.sharded_score_offline(eng._params, eng.cfg, eng.mesh,
                                           eng._base_seed, seeds, xt, k,
                                           SHARDED_KC).cpu().numpy()
    atol, rtol = TOL["bf16"]
    ref = one(SHARDED_GLOO_K)
    got = np.array(r0["score"])
    err = np.abs(got - ref)
    score_ok = bool((err <= atol + rtol * np.abs(ref)).all())
    ad = np.array(r0["adaptive"])
    fixed = np.array([one(u)[i] for i, u in enumerate(ku)])
    aerr = np.abs(ad[:, 0] - fixed)
    grid_ok = all(u % (sp * SHARDED_KC) == 0 or u == SHARDED_KMAX
                  for u in ku)
    adapt_ok = bool((aerr <= atol + rtol * np.abs(fixed)).all()) and grid_ok
    print(f"sharded: gloo {GLOO_MESH} rank 0's engine, followers in "
          f"serve_rank: score k={SHARDED_GLOO_K} of {SHARDED_BATCH} rows vs "
          f"the world of "
          f"one, max_abs_err {err.max():.3e}; score_adaptive "
          f"{ADAPTIVE_TARGETS[0]} k_used {ku} (on the {sp * SHARDED_KC}-"
          f"sample round grid: {grid_ok}) vs the world of one's fixed-k "
          f"score at k_used, max_abs_err {aerr.max():.3e} (tol {atol:g} + "
          f"{rtol:g}*|ref|) {'ok' if score_ok and adapt_ok else 'FAIL'}; "
          f"followers served 2 dispatches each and exited on stop(): "
          f"{served_ok}; rank 0 served both in {r0['wall']:.3f}s, world wall "
          f"{wall:.1f}s (gloo copies through the host, 4 ranks share one "
          f"card: no speed number)", flush=True)
    print(f"sharded: gloo B1 launches summed over the ranks {launches} "
          f"(expected {want}) {'ok' if launch_ok else 'FAIL'}", flush=True)

    # a follower dies mid-dispatch: rank 0's futures error, no hang
    t0 = time.perf_counter()
    codes = multihost.spawn(
        _sharded_rank, 2, (f"file://{tmp}/sharded-kill-rendezvous", tmp,
                           run_dir, x, (1, 2), True), timeout=300, grace=30)
    with open(f"{tmp}/sharded-rank0.json") as f:
        k0 = json.load(f)
    kill_ok = codes == [0, 3] and k0.get("error") is not None and \
        k0["waited"] < 120
    print(f"sharded: world of 2, the follower killed on its first "
          f"dispatch: exit codes {codes}, rank 0's future errored after "
          f"{k0.get('waited', float('nan')):.2f}s ({k0.get('error')}), "
          f"stop() raised {k0.get('stop_error')}; in "
          f"{time.perf_counter() - t0:.1f}s {'ok' if kill_ok else 'FAIL'}",
          flush=True)
    return launches, score_ok and adapt_ok and served_ok and launch_ok \
        and kill_ok


def sharded_cli(np, run_dir):
    """Phase 10c: the serving CLI on the card from phase 7's run dir, one
    score and one encode line on stdin. Returns ok."""
    row = [float(v % 2) for v in range(784)]
    req = "".join(json.dumps({"op": op, "x": row}) + "\n"
                  for op in ("score", "encode"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "iwae_replication_project_tpu_torch.serving",
         "--checkpoint", run_dir, "--interactive"], input=req,
        capture_output=True, text=True, timeout=300,
        cwd=str(Path(__file__).resolve().parent))
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    ok = proc.returncode == 0 and len(lines) == 3 and \
        [ln.get("op") for ln in lines[1:]] == ["score", "encode"] and \
        bool(np.isfinite(lines[1]["result"])) and \
        len(lines[2]["result"]) == 50
    print(f"sharded: cli --checkpoint RUN_DIR --interactive, one score "
          f"and one encode line: exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f}s, device "
          f"{lines[0].get('device') if lines else None}, score "
          f"{lines[1].get('result') if len(lines) > 1 else None} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        print(proc.stdout[-2000:], proc.stderr[-4000:], flush=True)
    return ok


class _Recorder:
    """Wraps an engine's ``_launch`` and keeps every dispatch it made (the
    phase's launch accounting and the offline-twin check replay them)."""

    def __init__(self, eng):
        self.eng, self.log, self._launch = eng, [], eng._launch

        def recording(batch):
            inf = self._launch(batch)
            self.log.append(inf)
            return inf
        eng._launch = recording


def _tier_quotas(policy, tenant):
    """Token buckets on one client id only (the tier's ClientQuotas meters
    every principal under one policy; the phase's stream must not be)."""
    from iwae_replication_project_tpu_torch.serving.frontend import (
        ClientQuotas)

    class OneTenant(ClientQuotas):
        def admit(self, client, cost, model=None):
            if client == tenant:
                super().admit(client, cost, model=model)

        def refund(self, client, cost, model=None):
            if client == tenant:
                super().refund(client, cost, model=model)
    return OneTenant(policy)


def _wire_stream(np, c, reqs):
    """Pipeline `reqs` ((op, rows, k, seed, kw)) on one TierClient; returns
    the responses in request order and each one's latency (submit to its
    response read, host clock) and the wall time."""
    t0 = time.perf_counter()
    sent = {}
    for i, (op, rows, k, seed, kw) in enumerate(reqs):
        sent[c.submit(op, rows, k=k, seed=seed, **kw)] = \
            (i, time.perf_counter())
    out, lat = [None] * len(reqs), [0.0] * len(reqs)
    while sent:
        resp = c._read_one()
        i, t1 = sent.pop(resp["id"])
        out[i], lat[i] = resp, time.perf_counter() - t1
    return out, np.array(lat), time.perf_counter() - t0


def _lat_text(np, name, lat, n, wall) -> str:
    return (f"{name}: {n} requests p50_ms={np.percentile(lat, 50) * 1e3:.3f} "
            f"p99_ms={np.percentile(lat, 99) * 1e3:.3f} requests_per_s="
            f"{n / wall:.1f}")


def serving_tier(torch, np, hot_loop, run_dir):
    """Phase 11: the serving tier over TCP on the card, from phase 7's run
    dir. Returns (B1 launches of the phase's traffic, the row-invariant
    kernels' launches, ok)."""
    from iwae_replication_project_tpu_torch.ops import row_invariant as ri
    from iwae_replication_project_tpu_torch.serving.engine import (
        ServingEngine)
    from iwae_replication_project_tpu_torch.serving.faults import (
        crash_replica)
    from iwae_replication_project_tpu_torch.serving.frontend import (
        QuotaPolicy, RetryPolicy, ServingTier, TierClient)
    from iwae_replication_project_tpu_torch.serving.frontend.client import (
        TierError)
    from iwae_replication_project_tpu_torch.serving.sharded import (
        ShardedScoreEngine)
    from iwae_replication_project_tpu_torch.telemetry.tracing import (
        FlightRecorder)
    from iwae_replication_project_tpu_torch.parallel import eval as peval
    from iwae_replication_project_tpu_torch.utils import faults

    t_phase = time.perf_counter()
    kc = SHARDED_KC
    first = ServingEngine(run_dir, timeout_s=None, k_max=TIER_THRESHOLD)

    def fast():
        return ServingEngine(params=first._params, model_config=first.cfg,
                             k=first.k, k_max=TIER_THRESHOLD, timeout_s=None)
    engines = [first, fast()]
    big = ShardedScoreEngine(params=first._params, model_config=first.cfg,
                             k=first.k, k_chunk=kc, k_max=SHARDED_KMAX,
                             max_batch=SHARDED_BATCH, timeout_s=None)
    policy = QuotaPolicy(rate=TIER_QUOTA[0], burst=TIER_QUOTA[1])
    tier = ServingTier(engines + [big], quota=policy,
                       large_k_threshold=TIER_THRESHOLD, tracing=True,
                       recorder=FlightRecorder(sample_every=1, capacity=512),
                       monitor_interval_s=0.05)
    tier.quotas = _tier_quotas(policy, TIER_TENANT)
    ok = first.cfg.compute_dtype == "bfloat16" and \
        first.cfg.likelihood == "logits" and first.device.type == "cuda"
    warm = tier.warmup()
    tier.start()
    torch.cuda.synchronize()
    info = tier.info()
    print(f"tier: ServingTier on 127.0.0.1:{tier.port}, 2 fast replicas "
          f"(k={first.k}, buckets {info['buckets']}, k_max "
          f"{first.k_max}) + 1 sharded (k_chunk={kc}, k_max={big.k_max}, "
          f"buckets {list(big.ladder.buckets)}), large_k_threshold="
          f"{info['large_k_threshold']}, tracing on, quota {TIER_QUOTA} on "
          f"client {TIER_TENANT!r}; warmup {warm}", flush=True)

    rec = [_Recorder(e) for e in engines + [big]]
    rng = np.random.RandomState(11)
    data = (rng.rand(4096, first.cfg.x_dim) > 0.5).astype(np.float32)
    # the large-k route takes the loaders' synthetic test rows, as phase 10
    # does: on the trained model random rows reach no target SE
    from iwae_replication_project_tpu_torch import zoo
    from iwae_replication_project_tpu_torch.data import load_dataset
    ds = load_dataset(zoo.get(PRESET).dataset, data_dir="data")
    test = ds.x_test.reshape(len(ds.x_test), -1).astype(np.float32)
    h_dim = first.row_dims["decode"]
    hot_loop.reset_launch_counts()
    ri.reset_launch_counts()

    # the lone request: over the wire and in process, in turns
    lone_wire, lone_local = [], []
    c = TierClient("127.0.0.1", tier.port, timeout_s=300)
    for i in range(TIER_LONE):
        t1 = time.perf_counter()
        c.score([data[i].tolist()], seed=900_000 + i)
        lone_wire.append(time.perf_counter() - t1)
        t1 = time.perf_counter()
        first.submit("score", data[i], seed=950_000 + i).result(timeout=300)
        lone_local.append(time.perf_counter() - t1)
    wire50, local50 = (np.percentile(v, 50) * 1e3
                       for v in (lone_wire, lone_local))
    print(f"tier: lone score request ({TIER_LONE} each, in turns) p50_ms "
          f"over the wire={wire50:.3f} in process={local50:.3f}: the wire "
          f"and the router cost {wire50 - local50:.3f} ms", flush=True)

    # the fast route: a ragged stream of score/encode/decode at k=50;
    # single rows carry explicit seeds, other rows take the tier's minted
    # seeds in admission order (0, 1, 2, ...)
    reqs, replay, minted, j = [], [], 0, 0
    for i in range(TIER_FAST_REQUESTS):
        op = ("score", "score", "encode", "decode")[i % 4]
        n = TIER_SIZES[i % len(TIER_SIZES)]
        rows = (data[j:j + n] if op != "decode"
                else rng.randn(n, h_dim).astype(np.float32))
        j = (j + n) % (len(data) - 32)
        seed = 100_000 + i if n == 1 else None
        seeds = [seed] if n == 1 else list(range(minted, minted + n))
        minted += 0 if n == 1 else n
        reqs.append((op, rows.tolist(), None, seed, {}))
        replay.append((op, rows, seeds))
    resps, lat, wall = _wire_stream(np, c, reqs)
    fast_ok = all(r["ok"] for r in resps)
    n_rows = sum(len(x[1]) for x in reqs)
    print("tier: " + _lat_text(np, f"fast route ({n_rows} rows, groups of "
                               f"{min(TIER_SIZES)}-{max(TIER_SIZES)})", lat,
                               len(reqs), wall)
          + f" all ok={fast_ok}", flush=True)
    ok &= fast_ok

    # the large-k route: score at k in {1000, 5000}, then score_adaptive
    big_reqs = [("score", [test[i % len(test)].tolist()], k, 200_000 + i,
                 {}) for i, k in enumerate(TIER_LARGE_K)]
    big_resps, big_lat, big_wall = _wire_stream(np, c, big_reqs)
    ada_reqs = [("score_adaptive", [test[(100 + i) % len(test)].tolist()],
                 SHARDED_KMAX, 300_000 + i, {"target_se": 0.5})
                for i in range(TIER_ADAPTIVE)]
    ada_resps, ada_lat, ada_wall = _wire_stream(np, c, ada_reqs)
    large_ok = all(r["ok"] for r in big_resps + ada_resps)
    ok &= large_ok
    k5000 = [t for t, (_, _, k, _, _) in zip(big_lat, big_reqs)
             if k == SHARDED_KMAX]
    print("tier: " + _lat_text(np, f"large-k score k in "
                               f"{sorted(set(TIER_LARGE_K))}", big_lat,
                               len(big_reqs), big_wall)
          + f"; k={SHARDED_KMAX} alone p50_ms="
          f"{np.percentile(k5000, 50) * 1e3:.3f}", flush=True)
    print("tier: " + _lat_text(np, f"score_adaptive k_cap {SHARDED_KMAX} "
                               f"target_se 0.5", ada_lat, len(ada_reqs),
                               ada_wall)
          + f"; k_used {[int(r['result'][0][2]) for r in ada_resps]}; all "
          f"ok={large_ok}", flush=True)

    # a fast replica crashed under a burst (the one the single-row score
    # group is affine to, at its next launch): every accepted request is
    # answered
    crash_reqs = [("score", [data[3200 + i].tolist()], None, 400_000 + i,
                   {}) for i in range(TIER_CRASH_REQUESTS)]
    victim = tier.router._affinity.get((None, "score", None), 0)
    faults.install(faults.FaultSchedule([crash_replica(engines[victim])]))
    try:
        crash_resps, _, _ = _wire_stream(np, c, crash_reqs)
    finally:
        faults.clear()
    st = tier.stats()
    crash_ok = all(r["ok"] for r in crash_resps) and \
        st["router"]["router/reroutes"] > 0 and \
        st["router"]["router/replica_failures"] == 1
    ok &= crash_ok
    print(f"tier: crash_replica(replica {victim}) under a burst of "
          f"{len(crash_reqs)} requests: answered "
          f"{sum(r['ok'] for r in crash_resps)}/{len(crash_reqs)}, "
          f"router/reroutes={st['router']['router/reroutes']} "
          f"replica_failures={st['router']['router/replica_failures']} "
          f"{'ok' if crash_ok else 'FAIL'}", flush=True)

    # the quota'd client: typed quota_exceeded with its wait, then a
    # retrying client gets through
    q_codes = []
    with TierClient("127.0.0.1", tier.port, client_id=TIER_TENANT,
                    timeout_s=300) as qc:
        for i in range(4):
            try:
                qc.score(data[3300:3304].tolist())
                q_codes.append("ok")
            except TierError as e:
                q_codes.append((e.code, e.retry_after_s))
    rejected = [x for x in q_codes if x != "ok"]
    with TierClient("127.0.0.1", tier.port, client_id=TIER_TENANT,
                    timeout_s=300, retry=RetryPolicy(seed=0,
                                                     deadline_s=30.0)) as qc:
        t1 = time.perf_counter()
        got_through = [len(qc.score(data[3310:3314].tolist()))
                       for _ in range(3)] == [4, 4, 4]
        retry_s = time.perf_counter() - t1
        retries = qc.retry_stats["retries"]
    quota_ok = bool(rejected) and all(
        code == "quota_exceeded" and hint is not None and hint > 0
        for code, hint in rejected) and got_through and retries > 0
    ok &= quota_ok
    print(f"tier: quota'd client {TIER_TENANT!r}: {q_codes}; a RetryPolicy "
          f"client then served 3 requests of 4 rows in {retry_s:.3f}s with "
          f"{retries} retries {'ok' if quota_ok else 'FAIL'}", flush=True)

    # the traces op: tier/request -> router/attempt-1 -> engine stages
    docs = c.traces()["traces"]
    c.close()
    trees = 0
    for d in docs:
        by_id = {s["span_id"]: s for s in d["spans"]}
        parent = {s["name"]: by_id.get(s["parent_id"], {}).get("name")
                  for s in d["spans"]}
        trees += parent.get("router/attempt-1") == "tier/request" and all(
            parent.get(n) == "router/attempt-1"
            for n in ("engine/queue", "engine/dispatch", "engine/device",
                      "engine/fetch"))
    spans = [len(d["spans"]) for d in docs]
    trace_ok = trees > 0
    ok &= trace_ok
    print(f"tier: traces op: {len(docs)} retained, {trees} with the engine "
          f"stages under router/attempt-1 under tier/request; spans per "
          f"request min/median/max {min(spans)}/{int(np.median(spans))}/"
          f"{max(spans)} {'ok' if trace_ok else 'FAIL'}", flush=True)
    # where a request's time goes, by route: the median of each span's
    # duration (a multi-row request has one attempt and stage set per row)
    for route, pick in (("fast", lambda a: a.get("k") is None),
                        ("large-k", lambda a: a.get("k") is not None)):
        durs = {}
        for d in docs:
            root = next((x for x in d["spans"]
                         if x["name"] == "tier/request"), None)
            if root is None or not pick(root["attrs"]):
                continue
            for x in d["spans"]:
                durs.setdefault(x["name"], []).append(x["duration_s"])
        names = ("tier/request", "tier/admit", "router/attempt-1",
                 "engine/queue", "engine/pad", "engine/dispatch",
                 "engine/noise", "engine/args", "engine/launch",
                 "engine/device", "engine/fetch")
        print(f"tier: {route} route, median span ms over "
              f"{len(durs.get('tier/request', []))} traced requests: "
              + ", ".join(f"{n} {np.median(durs[n]) * 1e3:.3f}"
                          for n in names if n in durs), flush=True)

    tier.stop()
    torch.cuda.synchronize()
    launches = hot_loop.launch_counts()
    row_launches = ri.launch_counts()
    for r in rec:
        r.eng._launch = r._launch
    want = sum(1 for r in rec[:2] for inf in r.log if inf.op == "score")
    for inf in rec[2].log:
        if inf.op == "score":
            want += math.ceil(inf.k / kc)
        else:
            want += _adaptive_launches(
                [float(q.future.result()[2]) for q in inf.batch], 1, 1, kc)
    launch_ok = launches == {hot_loop.KERNEL: want, hot_loop.KERNEL_BWD: 0}
    ok &= launch_ok
    print(f"tier: B1 launches over the phase {launches} (expected {want}: "
          f"one per fast score dispatch, "
          f"{sum(1 for r in rec[:2] for inf in r.log if inf.op == 'score')}"
          f"; ceil(k/{kc}) per sharded score dispatch and the adaptive rule "
          f"per score_adaptive one, {len(rec[2].log)} sharded dispatches) "
          f"{'ok' if launch_ok else 'FAIL'}", flush=True)

    # every fast dispatch against one direct in-process engine fed the
    # same rows and seeds in one flush (the same bucket, so the same
    # shapes): bitwise
    direct = fast()
    same_fast, n_fast = True, 0
    for r in rec[:2]:
        for inf in r.log:
            fs = [direct.submit(inf.op, q.payload, k=inf.k or None,
                                seed=q.seed) for q in inf.batch]
            direct.flush()
            got = np.stack([q.future.result() for q in inf.batch])
            same_fast &= np.array_equal(
                got, np.stack([f.result(timeout=300) for f in fs]))
            n_fast += len(inf.batch)
    # and each request's rows replayed alone, in the bucket of its own
    # row count: bitwise, the serving programs' ops being row-invariant
    # (the count within 1e-3 nats and the worst difference printed too)
    errs = {op: [0.0] for op in ("score", "encode", "decode")}
    equal = {op: 0 for op in errs}
    close = {op: 0 for op in errs}
    rows_n = {op: 0 for op in errs}
    within = True
    replays = replay + [(op, np.asarray(rows, np.float32), [seed])
                        for op, rows, _, seed, _ in crash_reqs]
    for (op, rows, seeds), resp in zip(replays, resps + crash_resps):
        fs = [direct.submit(op, row, seed=sd) for row, sd in zip(rows, seeds)]
        direct.flush()
        want_ = np.stack([f.result(timeout=300) for f in fs])
        got = np.asarray(resp["result"], np.float32)
        err = np.abs(got - want_).reshape(len(rows), -1).max(axis=1)
        errs[op].append(float(err.max()))
        equal[op] += int((err == 0).sum())
        close[op] += int((err <= 1e-3).sum())
        rows_n[op] += len(rows)
    within = all(equal[op] == rows_n[op] for op in errs)
    replay_ok = same_fast and within
    ok &= replay_ok
    print(f"tier: {n_fast} rows of {sum(len(r.log) for r in rec[:2])} fast "
          f"dispatches bitwise equal to one direct in-process engine fed "
          f"the same rows and seeds: {same_fast}; each request replayed "
          f"alone (its own bucket): " + "; ".join(
              f"{op} {equal[op]}/{rows_n[op]} bitwise, {close[op]} within "
              f"1e-3, max_abs_err {max(errs[op]):.3e}" for op in errs)
          + f"; held bitwise {'ok' if replay_ok else 'FAIL'}", flush=True)

    # every large-k dispatch bitwise its offline twin on the padded rows
    same = True
    for inf in rec[2].log:
        n = len(inf.batch)
        x, seeds = _padded(np, np.stack([q.payload for q in inf.batch]),
                           [q.seed for q in inf.batch], inf.bucket)
        xt = torch.from_numpy(x).cuda()
        got = np.stack([q.future.result() for q in inf.batch])
        if inf.op == "score":
            off = peval.sharded_score_offline(
                big._params, big.cfg, big.mesh, big._base_seed, seeds, xt,
                inf.k, kc)
        else:
            q0 = inf.batch[0]
            off = peval.sharded_score_adaptive_offline(
                big._params, big.cfg, big.mesh, big._base_seed, seeds, xt,
                k_cap=inf.k, target_se=q0.target_se,
                ess_floor=q0.ess_floor, k_chunk=kc)
        same &= np.array_equal(got, off[:n].cpu().numpy())
    ok &= same
    print(f"tier: {len(rec[2].log)} large-k dispatches bitwise equal to "
          f"the offline twin on their padded rows: {same}; phase "
          f"{time.perf_counter() - t_phase:.1f}s before the command line",
          flush=True)
    return launches[hot_loop.KERNEL], row_launches, ok


def tier_cli(run_dir):
    """Phase 11b: the CLI's tier mode from the run dir (stdin held open)
    and its client mode against it. Returns ok."""
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parent)
    t0 = time.perf_counter()
    tier = subprocess.Popen(
        [sys.executable, "-m", "iwae_replication_project_tpu_torch.serving",
         "--checkpoint", run_dir, "--replicas", "2", "--sharded-replicas",
         "1", "--port", "0"], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=root,
        env=env)
    ready, client, final = None, None, None
    try:
        while ready is None:
            line = tier.stdout.readline()
            if not line:
                break
            if line.startswith("{"):
                ready = json.loads(line)
        if ready is not None:
            client = subprocess.run(
                [sys.executable, "-m",
                 "iwae_replication_project_tpu_torch.serving", "--client",
                 f"127.0.0.1:{ready['tier']['port']}", "--requests", "40",
                 "--k-sweep", "250,5000", "--target-se", "0.5"],
                capture_output=True, text=True, timeout=300, cwd=root,
                env=env)
        tier.stdin.close()
        rc = tier.wait(timeout=300)
        rest = tier.stdout.read().strip().splitlines()
        final = json.loads(rest[-1]) if rest else None
    finally:
        if tier.poll() is None:
            tier.kill()
            tier.wait(timeout=30)
    sweep = json.loads(client.stdout.strip().splitlines()[-1]) \
        if client is not None and client.returncode == 0 else None
    ok = ready is not None and client is not None and \
        client.returncode == 0 and rc == 0 and sweep is not None and \
        sweep["errors"] == {} and sweep["op"] == "score_adaptive" and \
        final is not None and final["router"]["router/errors"] == 0
    print(f"tier: cli --checkpoint RUN_DIR --replicas 2 --sharded-replicas "
          f"1 --port 0 (device {ready.get('device') if ready else None}, "
          f"threshold {ready['tier']['large_k_threshold'] if ready else None})"
          f" and --client --requests 40 --k-sweep 250,5000 --target-se 0.5: "
          f"client exit {client.returncode if client else None} per_k "
          f"{sweep['per_k'] if sweep else None}; tier exit {rc} after stdin "
          f"EOF, router/completed "
          f"{final['router']['router/completed'] if final else None}; "
          f"{time.perf_counter() - t0:.1f}s {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        print(tier.stderr.read()[-4000:] if tier.stderr else "",
              client.stderr[-4000:] if client else "", flush=True)
    return ok


# --------------------------------------------------------------------------
# phase 12: the elastic multi-model tier
# --------------------------------------------------------------------------

def dense_bound_ms(m, k, n, dtype) -> tuple:
    """(bound_ms, bound_by) of one row-invariant dense layer: 2 M K N
    operations over the operand type's peak against each input read and
    the output written once."""
    t_ops = 2.0 * m * k * n / PEAK_FLOPS[dtype]
    t_bytes = 4.0 * (m * k + k * n + n + m * n) / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sum_bound_ms(outer, r, inner) -> tuple:
    """(bound_ms, bound_by) of one fixed-order sum: R - 1 adds per output
    in fp32 against the input read and the output written once."""
    t_ops = outer * max(r - 1, 1) * inner / PEAK_FLOPS["fp32"]
    t_bytes = 4.0 * (outer * r * inner + outer * inner) / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_row_kernels(torch, ri):
    """Phase 3d: the serving programs' row-invariant kernels against their
    plain versions at the flagship's serving shapes (a 64-row bucket, k=50:
    the encoder's first block at 64 rows, the rest at 3200, the decode
    output block at 64), timed with the library call computing the same
    function (``torch.addmm`` on the same, already rounded operands;
    ``torch.sum``). Returns (two records for the JSON line, ok)."""
    dense_shapes = [(64, 784, 200, True), (64, 200, 100, False),
                    (3200, 100, 100, True), (3200, 100, 50, False),
                    (3200, 50, 100, True), (3200, 100, 100, False),
                    (64, 200, 784, False), (1, 784, 200, True),
                    (7, 37, 130, True)]
    ok, worst_d, main_d = True, 0.0, None
    for dtype in ("fp32", "bf16"):
        cd = torch.bfloat16 if dtype == "bf16" else None
        for i, (m, k, n, tanh) in enumerate(dense_shapes):
            g = torch.Generator().manual_seed(100 + i)
            x = torch.randn((m, k), generator=g).cuda()
            w = (torch.randn((k, n), generator=g) * k ** -0.5).cuda()
            b = (torch.randn((n,), generator=g) * 0.1).cuda()
            got = ri.dense(x, w, b, cd, tanh)
            want = ri.dense_plain(x, w, b, cd, tanh)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            # the same products in another order: K terms whose absolute
            # sum is ~20 here, so ~sqrt(K) 2^-24 20 apart; 2e-4 allows it
            within = err <= 2e-4 and bool(torch.isfinite(got).all())
            ok &= within
            worst_d = max(worst_d, err)
            line = (f"kernel row_dense {dtype} M={m} K={k} N={n} "
                    f"tanh={tanh}: max_abs_err={err:.3e} tol=2e-4 "
                    f"{'ok' if within else 'OUT OF TOLERANCE'}")
            if m in (64, 3200) and i < 7:
                xr, wr = (x.to(cd).float(), w.to(cd).float()) if cd \
                    else (x, w)
                t = timings(lambda: ri.dense(x, w, b, cd, tanh),
                            lambda: ri.dense_plain(x, w, b, cd, tanh),
                            torch)
                lib = time_ms(lambda: torch.addmm(b, xr, wr), torch)
                bound, by = dense_bound_ms(m, k, n, dtype)
                line += timing_text(t, bound, by, 2.0 * m * k * n) + \
                    f" library_ms(torch.addmm)={lib:.4f}"
                if dtype == "bf16" and (m, k, n, tanh) == (3200, 100, 100,
                                                           False):
                    main_d = dict(t, bound_ms=bound, bound_by=by,
                                  library_ms=lib)
            print(line, flush=True)
    sum_shapes = [((50, 64, 100), -1), ((50, 64, 50), -1), ((50, 64), 0),
                  ((50, 64, 50), 0), ((1, 1, 784), -1), ((250, 8), 0)]
    worst_s, main_s = 0.0, None
    for i, (shape, dim) in enumerate(sum_shapes):
        g = torch.Generator().manual_seed(200 + i)
        x = torch.randn(shape, generator=g).cuda()
        got = ri.fixed_sum(x, dim)
        want = torch.sum(x, dim=dim)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        # fp32 terms of magnitude ~1 added in another order, at most 784
        within = err <= 1e-4 and bool(torch.isfinite(got).all())
        ok &= within
        worst_s = max(worst_s, err)
        d = dim % len(shape)
        outer, r, inner = (math.prod(shape[:d]), shape[d],
                           math.prod(shape[d + 1:]))
        t = timings(lambda: ri.fixed_sum(x, dim),
                    lambda: torch.sum(x, dim=dim), torch)
        bound, by = sum_bound_ms(outer, r, inner)
        line = (f"kernel row_sum {tuple(shape)} dim={dim}: "
                f"max_abs_err={err:.3e} tol=1e-4 "
                f"{'ok' if within else 'OUT OF TOLERANCE'}"
                + timing_text(t, bound, by)
                + f" library_ms(torch.sum)={t['plain_ms']:.4f}")
        if i == 0:
            main_s = dict(t, bound_ms=bound, bound_by=by,
                          library_ms=t["plain_ms"])
        print(line, flush=True)
    src = "iwae_replication_project_tpu_torch/csrc/"
    why = ("no TPU kernel: the serving programs' cuBLAS GEMMs and torch.sum "
           "reductions, row-invariant as iwae_replication_project_tpu/"
           "serving/programs.py:1")
    records = [
        {"name": ri.KERNEL_DENSE, "route": "cuda",
         "source": src + "row_dense.cu", "replaces": why, "launches": None,
         "max_abs_err": worst_d, **main_d,
         "bound_share": main_d["bound_ms"] / main_d["ms"],
         "shape": "bf16 M=3200 K=100 N=100"},
        {"name": ri.KERNEL_SUM, "route": "cuda",
         "source": src + "row_sum.cu", "replaces": why, "launches": None,
         "max_abs_err": worst_s, **main_s,
         "bound_share": main_s["bound_ms"] / main_s["ms"],
         "shape": "[50, 64, 100] over the last axis"}]
    return records, ok


def _serve_rows(eng, op, rows, seeds, k=None):
    """`rows` as one batch with `seeds` (serial engine): the results."""
    fs = [eng.submit(op, r, k=k, seed=s) for r, s in zip(rows, seeds)]
    eng.flush()
    return [f.result(timeout=300) for f in fs]


def bucket_invariance(torch, np, run_dir):
    """Phase 12a: every row of a seeded ragged set served in each bucket
    1..64 beside other neighbours (fast engine, score/encode/decode, bf16
    and fp32), and a k=5000 row in buckets 1, 2, 4 and 8 of the sharded
    engine: each row's bits the same in every bucket. Returns ok."""
    from iwae_replication_project_tpu_torch.serving.buckets import (
        BucketLadder)
    from iwae_replication_project_tpu_torch.serving.engine import (
        ServingEngine)
    from iwae_replication_project_tpu_torch.serving.sharded import (
        ShardedScoreEngine)
    from iwae_replication_project_tpu_torch.utils import compile_cache as cc

    t0 = time.perf_counter()
    ok = True
    n_rows = 8
    with cc.isolated_aot_registry(budget_bytes=None):
        for precision in ("bf16", "fp32"):
            eng = ServingEngine(run_dir, precision=precision,
                                ladder=BucketLadder(tuple(range(1, 65))),
                                timeout_s=None)
            for op in ("score", "encode", "decode"):
                rng = np.random.RandomState(12)
                d = eng.row_dims[op]

                def draw(n):
                    return (rng.rand(n, d) > 0.5).astype(np.float32) \
                        if op != "decode" else \
                        rng.randn(n, d).astype(np.float32)
                targets = draw(n_rows)
                got = {r: [] for r in range(n_rows)}
                neighbour_seed = 100_000
                for b in range(1, 65):
                    order = list(rng.permutation(n_rows))
                    while order:
                        mine, order = order[:b], order[b:]
                        slots = sorted(rng.choice(b, len(mine),
                                                  replace=False))
                        rows, seeds, where = draw(b), [], {}
                        for j in range(b):
                            if slots and j == slots[0]:
                                r = mine[len(where)]
                                rows[j], where[r] = targets[r], j
                                seeds.append(500 + r)
                                slots.pop(0)
                            else:
                                seeds.append(neighbour_seed)
                                neighbour_seed += 1
                        out = _serve_rows(eng, op, rows, seeds)
                        for r, j in where.items():
                            got[r].append(np.asarray(out[j]))
                same = sum(all(np.array_equal(v, got[r][0])
                               for v in got[r]) for r in range(n_rows))
                ok &= same == n_rows
                print(f"invariance: fast {precision} {op}: {same}/{n_rows} "
                      f"rows bitwise the same in all 64 buckets (each "
                      f"beside other neighbours; "
                      f"{sum(len(v) for v in got.values())} servings) "
                      f"{'ok' if same == n_rows else 'FAIL'}", flush=True)
        big = ShardedScoreEngine(run_dir, k_chunk=SHARDED_KC,
                                 k_max=SHARDED_KMAX, max_batch=SHARDED_BATCH,
                                 timeout_s=None)
        rng = np.random.RandomState(13)
        row = (rng.rand(784) > 0.5).astype(np.float32)
        vals = []
        for b in big.ladder.buckets:
            rows = (rng.rand(b, 784) > 0.5).astype(np.float32)
            rows[b // 2] = row
            seeds = [900 + j for j in range(b)]
            seeds[b // 2] = 77
            vals.append(_serve_rows(big, "score", rows, seeds,
                                    k=SHARDED_KMAX)[b // 2])
        same = all(np.array_equal(v, vals[0]) for v in vals)
        ok &= same
        print(f"invariance: sharded k={SHARDED_KMAX} (k_chunk "
              f"{SHARDED_KC}) row in buckets {list(big.ladder.buckets)}: "
              f"{vals[0]:.6f}, bitwise the same in every bucket={same}; "
              f"phase 12a {time.perf_counter() - t0:.1f}s "
              f"{'ok' if same else 'FAIL'}", flush=True)
    return ok


def store_on_the_flagship(torch, np, run_dir):
    """Phase 12b: every (op, bucket) program of the flagship captured into
    the store: its replay bitwise its eager program, the capture's ms, the
    replay's and the eager program's device ms (CUDA events, 20 calls on
    the engine's stream), the store's bill beside the bytes reckoned from
    the shapes and the bytes the capture holds (the graph pool's segments
    plus the static inputs; the bill is the larger, C7); then an eviction
    of everything and the bytes it gave back. Returns ({op: sum of bills},
    {(op, bucket): replay ms}, ok)."""
    from iwae_replication_project_tpu_torch.serving.engine import (
        ServingEngine)
    from iwae_replication_project_tpu_torch.utils import compile_cache as cc

    eng = ServingEngine(run_dir, timeout_s=None)
    ok = True
    bills, replays = {}, {}
    rng = np.random.RandomState(14)
    with cc.isolated_aot_registry(budget_bytes=None):
        store = cc.executable_store()
        for op in ("score", "encode", "decode"):
            k = eng.k if op != "decode" else 0
            d = eng.row_dims[op]
            for bucket in eng.ladder.buckets:
                payload = (rng.rand(bucket, d) > 0.5).astype(np.float32) \
                    if op != "decode" else \
                    rng.randn(bucket, d).astype(np.float32)
                program = eng._program_for(op, k, bucket)
                with eng._launch_context():
                    args, kwargs = eng._dispatch_args(
                        op, k, bucket, payload, list(range(bucket)))
                    fn, tensors, _, _, graph = eng._entry(
                        op, k, bucket, program, args, kwargs)
                    nbytes = eng._program_nbytes(op, k, bucket)
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    exe, hit = cc.aot_warm(
                        eng._aot_name(op), fn, tensors,
                        build_key=eng._build_key(op, k, bucket),
                        model=eng.store_label, nbytes=nbytes, graph=graph,
                        sig=cc.signature(tensors))
                    torch.cuda.synchronize()
                    cap_ms = (time.perf_counter() - t1) * 1e3
                    replay = exe(*tensors)
                    eager = fn(*tensors)
                    torch.cuda.synchronize()
                    same = torch.equal(replay, eager)
                    rep_ms = time_ms(lambda: exe(*tensors), torch)
                    eag_ms = time_ms(lambda: fn(*tensors), torch)
                bill = store.entries()[-1]["bytes"]      # the MRU entry
                bills[op] = bills.get(op, 0) + bill
                replays[op, bucket] = rep_ms
                good = graph and not hit and same and \
                    bill == max(nbytes, exe.pool_bytes)
                ok &= good
                print(f"store: {op} bucket={bucket}: capture (with its "
                      f"warm-up run) {cap_ms:.2f} ms, replay "
                      f"{rep_ms:.4f} ms vs eager {eag_ms:.4f} ms (CUDA "
                      f"events, 20 calls back to back), bill {bill} B = "
                      f"max(reckoned {nbytes} B, held by the capture "
                      f"{exe.pool_bytes} B: pool segments + static inputs; "
                      f"static buffers {exe.static_bytes} B), replay "
                      f"bitwise eager={same} {'ok' if good else 'FAIL'}",
                      flush=True)
        torch.cuda.synchronize()
        pool = sum(e["pool_bytes"] for e in store.entries())
        before = torch.cuda.memory_reserved()
        store.set_budget(0)
        torch.cuda.empty_cache()
        freed = before - torch.cuda.memory_reserved()
        evict_ok = len(store) == 0 and freed > 0
        ok &= evict_ok
        print(f"store: every entry evicted ({len(store)} left): the "
              f"allocator gave back {freed} B after empty_cache (the "
              f"captures held {pool} B); bills per op {bills} "
              f"{'ok' if evict_ok else 'FAIL'}", flush=True)
    return bills, replays, ok


def _replay_dispatches(np, engines_by_model, recs):
    """Every recorded dispatch replayed on a dedicated engine of its model
    (the same rows, seeds and k, one flush): (rows bitwise equal, rows)."""
    same, n = 0, 0
    for r in recs:
        eng = engines_by_model[r.eng.model]
        for inf in r.log:
            want = _serve_rows(eng, inf.op, [q.payload for q in inf.batch],
                               [q.seed for q in inf.batch],
                               k=inf.k or None)
            for q, w in zip(inf.batch, want):
                if q.future.exception() is None:
                    same += int(np.array_equal(q.future.result(), w))
                    n += 1
    return same, n


def multi_model_tier(torch, np, hot_loop, bills):
    """Phase 12c: three full-width presets behind one TCP tier
    (``zoo.serving_engines``), the store's budget about one model's
    programs; a burst alternating the models, every answer bitwise a
    dedicated engine's; then ``crash_aot_dispatch`` on one dispatch.
    Returns (B1 launches of the burst, row kernels' launches, the store
    after the burst for phase 13f, ok)."""
    from iwae_replication_project_tpu_torch import zoo
    from iwae_replication_project_tpu_torch.ops import row_invariant as ri
    from iwae_replication_project_tpu_torch.serving.engine import (
        ServingEngine)
    from iwae_replication_project_tpu_torch.serving.faults import (
        crash_aot_dispatch)
    from iwae_replication_project_tpu_torch.serving.frontend import (
        ServingTier, TierClient)
    from iwae_replication_project_tpu_torch.utils import compile_cache as cc
    from iwae_replication_project_tpu_torch.utils import faults
    from iwae_replication_project_tpu_torch.utils.tree import tree_map

    t_phase = time.perf_counter()
    ok = True
    with cc.isolated_aot_registry(budget_bytes=None):
        store = cc.executable_store()
        engines = zoo.serving_engines(MM_PRESETS, timeout_s=None)
        tier = ServingTier(engines, monitor_interval_s=0.05)
        warm = tier.warmup(ops=("score", "encode", "decode"))
        costs = store.model_costs()
        budget = max(costs.values())
        store.set_budget(budget)
        tier.start()
        print(f"multimodel: ServingTier on 127.0.0.1:{tier.port} over "
              f"{MM_PRESETS}, one replica each; warmup {warm}; bills per "
              f"model {costs} (phase 12b's flagship per op: {bills}); "
              f"store budget {budget} B (the largest model's programs), "
              f"{len(store)} entries resident after it", flush=True)
        recs = [_Recorder(e) for e in engines]
        rng = np.random.RandomState(15)
        reqs = []
        for i in range(MM_REQUESTS):
            model = MM_PRESETS[i % len(MM_PRESETS)]
            op = ("score", "encode", "decode")[(i // 3) % 3]
            n = (1, 4, 9, 2, 16)[i % 5]
            d = engines[0].row_dims[op]
            rows = (rng.rand(n, d) > 0.5).astype(np.float32) \
                if op != "decode" else rng.randn(n, d).astype(np.float32)
            reqs.append((op, rows.tolist(), None,
                         700_000 + i if n == 1 else None, {"model": model}))
        torch.cuda.synchronize()
        hot_loop.reset_launch_counts()
        ri.reset_launch_counts()
        s0 = cc.cache_stats()
        with TierClient("127.0.0.1", tier.port, timeout_s=300) as c:
            resps, lat, wall = _wire_stream(np, c, reqs)
        torch.cuda.synchronize()
        d = cc.stats_delta(s0)
        after_burst = {"entries": store.entries(), "budget": budget,
                       "evictions": d["store_evictions"],
                       "readmits": d["store_readmits"]}
        launches = hot_loop.launch_counts()[hot_loop.KERNEL]
        row_launches = ri.launch_counts()
        all_ok = all(r["ok"] for r in resps)
        if not all_ok:
            print("multimodel: failed responses " + str(
                [(r.get("error"), r.get("message", "")[:300])
                 for r in resps if not r["ok"]][:4]), flush=True)
        want = sum(1 for r in recs for inf in r.log if inf.op == "score")
        churn = d["store_evictions"] > 0 and d["store_readmits"] > 0 and \
            d["kernel_builds"] == 0 and d["aot_warmups"] == 0
        ok &= all_ok and churn and launches == want
        print("multimodel: " + _lat_text(
            np, f"burst alternating {len(MM_PRESETS)} models "
            f"({sum(len(r[1]) for r in reqs)} rows, score/encode/decode)",
            lat, len(reqs), wall)
            + f"; all ok={all_ok}; store over the burst: hits "
            f"{d['store_hits']} misses {d['store_misses']} evictions "
            f"{d['store_evictions']} readmits {d['store_readmits']} "
            f"captures {d['aot_captures']} warm-ups {d['aot_warmups']} "
            f"kernel builds {d['kernel_builds']}; B1 launches {launches} "
            f"(expected {want}: one per score dispatch, replays included); "
            f"row kernels {row_launches} "
            f"{'ok' if all_ok and churn and launches == want else 'FAIL'}",
            flush=True)

        # crash_aot_dispatch on one dispatch: that batch fails, typed, and
        # the tier serves on once the monitor's probe readmits the replica
        row = (rng.rand(784) > 0.5).astype(np.float32).tolist()
        sched = faults.FaultSchedule([crash_aot_dispatch(times=1)])
        with TierClient("127.0.0.1", tier.port, timeout_s=300) as c:
            before = c.score([row], seed=7, model=MM_PRESETS[1])
            with faults.installed(sched):
                rid = c.submit("score", [row], seed=7, model=MM_PRESETS[1])
                crashed = c.drain([rid])[rid]
            t1 = time.perf_counter()
            while True:
                rid = c.submit("score", [row], seed=7, model=MM_PRESETS[1])
                after = c.drain([rid])[rid]
                if after["ok"] or time.perf_counter() - t1 > 60:
                    break
                time.sleep(0.05)
            others = [c.score([row], seed=7, model=m) for m in MM_PRESETS]
        crash_ok = len(sched.log) == 1 and crashed["ok"] is False and \
            crashed["error"] in ("unavailable", "internal") and \
            after["ok"] and after["result"] == before and \
            others[1] == before
        ok &= crash_ok
        print(f"multimodel: crash_aot_dispatch on one {MM_PRESETS[1]} "
              f"dispatch: fired {len(sched.log)}x, that request answered "
              f"{crashed.get('error')!r} (typed), the tier served it again "
              f"after {time.perf_counter() - t1:.2f}s, bitwise the answer "
              f"before={after.get('result') == before}; the other models "
              f"served on {'ok' if crash_ok else 'FAIL'}", flush=True)
        tier.stop(timeout_s=60)
        for r in recs:
            r.eng._launch = r._launch

    # every burst answer against a dedicated engine of its model (its own
    # copy of the weights, its own store), the same rows, seeds and k
    with cc.isolated_aot_registry(budget_bytes=None):
        dedicated = {e.model: ServingEngine(
            params=tree_map(lambda t: t.clone(), e._params),
            model_config=e.cfg, k=e.k, timeout_s=None, model=e.model)
            for e in engines}
        same, n = _replay_dispatches(np, dedicated, recs)
    eq_ok = same == n and n >= sum(len(r[1]) for r in reqs)
    ok &= eq_ok
    print(f"multimodel: {same}/{n} rows of the burst bitwise a dedicated "
          f"single-model engine's; phase 12c "
          f"{time.perf_counter() - t_phase:.1f}s "
          f"{'ok' if eq_ok else 'FAIL'}", flush=True)
    return launches, row_launches, after_burst, ok


def autoscaler(torch, np, hot_loop, run_dir):
    """Phase 12d: the autoscaler on the card (JAX
    scripts/autoscale_smoke.py's four claims at the flagship's width, from
    phase 7's run dir). Returns (B1 launches of the elastic run, ok)."""
    from iwae_replication_project_tpu_torch.serving.engine import (
        ServingEngine)
    from iwae_replication_project_tpu_torch.serving.faults import (
        SITE_ENGINE_LAUNCH)
    from iwae_replication_project_tpu_torch.serving.fleet import (
        AutoscaleConfig, FleetManager)
    from iwae_replication_project_tpu_torch.serving.frontend import (
        ServingTier, TierClient)
    from iwae_replication_project_tpu_torch.telemetry.slo import (
        SLOMonitor, SLOObjective)
    from iwae_replication_project_tpu_torch.utils import compile_cache as cc
    from iwae_replication_project_tpu_torch.utils import faults

    t_phase = time.perf_counter()
    first = ServingEngine(run_dir, timeout_s=30.0)

    def engine():
        return ServingEngine(params=first._params, model_config=first.cfg,
                             k=first.k, timeout_s=30.0)

    rng = np.random.RandomState(16)
    n = 4 * AS_PHASE
    rows = (rng.rand(n, 784) > 0.5).astype(np.float32)

    def burst(c, lo, hi):
        ids = [c.submit("score", [rows[i].tolist()]) for i in range(lo, hi)]
        done = c.drain(ids)
        return [done[rid] for rid in ids]

    static = ServingTier([engine()], monitor_interval_s=0.05)
    static.warmup(ops=("score",))
    static.start()
    try:
        with TierClient("127.0.0.1", static.port, timeout_s=300) as c:
            ref = [r["result"][0] for r in burst(c, 0, n)]
    finally:
        static.stop(timeout_s=60)

    slo = SLOMonitor(default=SLOObjective(latency_s=1e-6),
                     windows=((AS_FAST_S, "5m"), (AS_SLOW_S, "1h")))
    tier = ServingTier([first], slo=slo, monitor_interval_s=0.05)
    tier.warmup(ops=("score",))
    tier.start()
    mgr = FleetManager(tier, engine, AutoscaleConfig(
        min_replicas=1, max_replicas=3, scale_up_burn=1.0,
        scale_down_burn=0.25, up_cooldown_s=0.0, down_cooldown_s=0.5,
        seed=1234), warmup_ops=("score",), drain_timeout_s=60.0)
    joined, recs = [], [_Recorder(first)]

    def tracked():
        e = engine()
        joined.append(e)
        recs.append(_Recorder(e))
        return e
    mgr._factory = tracked
    sched = faults.FaultSchedule([faults.FaultRule(
        site=SITE_ENGINE_LAUNCH, after=0, times=None,
        match=lambda ctx: bool(joined) and ctx.get("engine") is joined[0],
        name="crash_replica",
        action=faults.raise_fault("replica crash (chaos)"))], seed=1234)
    torch.cuda.synchronize()
    hot_loop.reset_launch_counts()
    s0 = cc.cache_stats()
    resps, checks = [], {}
    t_join = []
    try:
        with faults.installed(sched), TierClient(
                "127.0.0.1", tier.port, timeout_s=300) as c:
            resps += burst(c, 0, AS_PHASE)
            t1 = time.perf_counter()
            d1 = mgr.step()
            t_join.append(time.perf_counter() - t1)
            checks["up on burn-breach"] = d1.action == "up" and \
                d1.rule == "burn-breach" and len(tier.router.engines) == 2
            tier.router.prime_affinity(None, "score", None, 1)
            resps += burst(c, AS_PHASE, 2 * AS_PHASE)
            deadline = time.perf_counter() + 60
            while not sched.log and time.perf_counter() < deadline:
                time.sleep(0.01)
            t1 = time.perf_counter()
            d2 = mgr.step()
            t_join.append(time.perf_counter() - t1)
            live = sum(1 for s in tier.router.replica_states()
                       if s["healthy"] and not s["draining"])
            checks["crash, then up again"] = bool(sched.log) and \
                d2.action == "up" and live == 2
            resps += burst(c, 2 * AS_PHASE, 3 * AS_PHASE)
            time.sleep(AS_FAST_S + 0.8)
            d3 = mgr.step()
            live = [s for s in tier.router.replica_states()
                    if s["healthy"] and not s["draining"]]
            checks["down on idle, by drain"] = d3.action == "down" and \
                d3.rule == "idle" and len(live) == 1 and \
                len(mgr.retired) == 1
            resps += burst(c, 3 * AS_PHASE, n)
        stats = tier.stats()
    finally:
        mgr.stop()
        tier.stop(timeout_s=60)
    torch.cuda.synchronize()
    d = cc.stats_delta(s0)
    launches = hot_loop.launch_counts()[hot_loop.KERNEL]
    for r in recs:
        r.eng._launch = r._launch
    want = sum(1 for r in recs for inf in r.log if inf.op == "score")
    got = [r["result"][0] for r in resps if r["ok"]]
    checks["every response bitwise the static tier's"] = \
        len(got) == n and got == ref
    checks["warm joins: 0 captures, 0 misses, 0 builds"] = \
        d["aot_captures"] == 0 and d["store_misses"] == 0 and \
        d["kernel_builds"] == 0
    checks["B1 launches = score dispatches"] = launches == want
    r = stats["router"]
    checks["reroutes after the crash"] = r["router/reroutes"] >= 1 and \
        r["router/replica_failures"] >= 1
    ok = all(checks.values())
    for rec in mgr.decision_log:
        print(f"autoscale: decision t={rec['t']:.3f} {rec['action']} "
              f"{rec['rule']}: {rec['reason']}", flush=True)
    print(f"autoscale: {len(got)}/{n} answered; joins took "
          f"{', '.join(f'{t:.3f}' for t in t_join)} s (step, warm join "
          f"included); store over the run: captures {d['aot_captures']} "
          f"misses {d['store_misses']} hits {d['store_hits']} kernel "
          f"builds {d['kernel_builds']}; B1 launches {launches} (expected "
          f"{want}); router reroutes {r['router/reroutes']} failures "
          f"{r['router/replica_failures']}; "
          + "; ".join(f"{k}: {v}" for k, v in checks.items())
          + f"; phase 12d {time.perf_counter() - t_phase:.1f}s "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return launches, ok


def multi_model_cli(bills):
    """Phase 12e: the CLI's tier mode with ``--replicas 1 --models A,B
    --store-budget-mb X --autoscale --autoscale-max 2`` on the card, a
    client burst per model through ``--client``. Returns ok."""
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parent)
    mb = max(1.0, sum(bills.values()) / 2 ** 20)
    models = ",".join(MM_PRESETS[:2])
    t0 = time.perf_counter()
    tier = subprocess.Popen(
        [sys.executable, "-m", "iwae_replication_project_tpu_torch.serving",
         "--replicas", "1", "--models", models, "--store-budget-mb",
         f"{mb:.3f}", "--autoscale", "--autoscale-max", "2", "--port", "0"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=root, env=env)
    ready, clients, final, rc = None, [], None, None
    try:
        line = tier.stdout.readline()
        if line.startswith("{"):
            ready = json.loads(line)
        if ready is not None:
            for m in MM_PRESETS[:2]:
                clients.append(subprocess.run(
                    [sys.executable, "-m",
                     "iwae_replication_project_tpu_torch.serving",
                     "--client", f"127.0.0.1:{ready['tier']['port']}",
                     "--requests", "30", "--model", m],
                    capture_output=True, text=True, timeout=300, cwd=root,
                    env=env))
        tier.stdin.close()
        rc = tier.wait(timeout=300)
        rest = tier.stdout.read().strip().splitlines()
        final = json.loads(rest[-1]) if rest else None
    finally:
        if tier.poll() is None:
            tier.kill()
            tier.wait(timeout=30)
    outs = [json.loads(c.stdout.strip().splitlines()[-1])
            if c.returncode == 0 else None for c in clients]
    ok = ready is not None and rc == 0 and len(outs) == 2 and \
        all(o is not None and o["errors"] == {} for o in outs) and \
        final is not None and final["router"]["router/errors"] == 0 and \
        ready["tier"]["models"] == sorted(MM_PRESETS[:2]) and \
        ready["tier"]["autoscale"] is not None
    store = {k: final["store"][k] for k in ("evictions", "readmits", "hits",
                                            "misses")} if final else None
    actions = [x["action"] for x in final["fleet"]["decisions"]][:8] \
        if final else None
    print(f"cli: --replicas 1 --models {models} --store-budget-mb {mb:.3f} "
          f"--autoscale --autoscale-max 2: ready models "
          f"{ready['tier']['models'] if ready else None} warmup "
          f"{ready['warmup'] if ready else None}; --client --requests 30 "
          f"per model: rows/s "
          f"{[o['rows_per_sec'] if o else None for o in outs]}; tier exit "
          f"{rc}, router/completed "
          f"{final['router']['router/completed'] if final else None}, "
          f"store {store}, fleet decisions {actions}; "
          f"{time.perf_counter() - t0:.1f}s {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        print(tier.stderr.read()[-4000:] if tier.stderr else "",
              [c.stderr[-2000:] for c in clients], flush=True)
    return ok

# --------------------------------------------------------------------------
# phase 13: the observability plane
# --------------------------------------------------------------------------

def _watch_observe(prof):
    """Wrap a profiler's ``observe``: keeps each call's keywords and the
    key's z after it (the snapshot's ``last_z``)."""
    seen = []
    observe = prof.observe

    def watched(**kw):
        finding = observe(**kw)
        key = prof._key(kw["program"], kw["bucket"], kw["k_class"])
        doc = prof.snapshot()["keys"].get(key, {})
        seen.append(dict(kw, key=key, z=doc.get("last_z")))
        return finding
    prof.observe = watched
    return seen


def profiled_serving(torch, np, hot_loop, run_dir, replays, smi):
    """Phase 13a: two flagship engines on phase 7's weights, profiling on
    and off, the same ragged score stream: rows bitwise the same, B1's
    launches equal to the score dispatches, the H100 row of the peak table;
    per profiler key its count, EWMA and p50 device ms, MFU, HBM fraction
    and ceiling ratio; score/b64 beside phase 12b's replay; the drift
    findings and the largest z. Returns (B1 launches, ok)."""
    from iwae_replication_project_tpu_torch.serving.engine import (
        ServingEngine)
    from iwae_replication_project_tpu_torch.telemetry.profiling import (
        detect_chip_peaks)
    from iwae_replication_project_tpu_torch.utils import compile_cache as cc

    peaks = detect_chip_peaks()
    ok = peaks["peak_flops"] == 989e12 and peaks["peak_hbm_bytes"] == 3.35e12
    print(f"obs: detect_chip_peaks() = {peaks} on {smi} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    rng = np.random.RandomState(16)
    sizes = [64 if i % 4 == 0 else int(rng.randint(1, 65))
             for i in range(OBS_GROUPS)]
    groups = [(rng.rand(n, 784) > 0.5).astype(np.float32) for n in sizes]
    rows = {True: [], False: []}
    with cc.isolated_aot_registry(budget_bytes=None):
        engines = {p: ServingEngine(run_dir, timeout_s=None, profiling=p)
                   for p in (True, False)}
        for eng in engines.values():
            eng.warmup(ops=("score",))
            eng.start()
        prof = engines[True].profiler
        seen = _watch_observe(prof)
        torch.cuda.synchronize()
        hot_loop.reset_launch_counts()
        d0 = {p: e.metrics.snapshot()["counters"]["dispatches"]
              for p, e in engines.items()}
        seed = 0
        for x in groups:
            for p, eng in engines.items():
                futs = [eng.submit("score", r, seed=seed + i)
                        for i, r in enumerate(x)]
                rows[p] += [f.result(timeout=300) for f in futs]
            seed += len(x)
        for eng in engines.values():
            eng.stop()
        torch.cuda.synchronize()
        launches = hot_loop.launch_counts()[hot_loop.KERNEL]
        dispatches = sum(e.metrics.snapshot()["counters"]["dispatches"]
                         - d0[p] for p, e in engines.items())
        same = sum(int(np.array_equal(a, b))
                   for a, b in zip(rows[True], rows[False]))
        hists = engines[True].metrics.registry.snapshot()["histograms"]
        snap = prof.snapshot()
    good = same == len(rows[True]) == sum(sizes) and \
        launches == dispatches and len(seen) == \
        engines[True].metrics.snapshot()["counters"]["dispatches"] - \
        d0[True] and engines[False].profiler is None
    ok &= good
    print(f"obs: profiled vs unprofiled flagship engines, {len(groups)} "
          f"groups of 1-64 rows at k=50 ({sum(sizes)} rows): {same}/"
          f"{len(rows[True])} rows bitwise; B1 launches {launches} = score "
          f"dispatches {dispatches} (both engines); {len(seen)} profiler "
          f"observations {'ok' if good else 'FAIL'}", flush=True)
    for key in sorted(snap["keys"], key=lambda k: int(
            k.split("/b")[1].split("/")[0])):
        doc = snap["keys"][key]
        h = hists.get(f"prof/device_s/{key}", {})
        print(f"obs: prof {key}: count {doc['count']}, EWMA "
              f"{doc['ewma_s'] * 1e3:.4f} ms, p50 "
              f"{(h.get('p50') or 0.0) * 1e3:.4f} ms (CUDA events), last_mfu "
              f"{doc['last_mfu']}, last_hbm_frac {doc['last_hbm_frac']}, "
              f"last_ceiling_ratio {doc['last_ceiling_ratio']} ({smi})",
              flush=True)
    b64 = snap["keys"].get("serve_score/b64/k50")
    h64 = hists.get("prof/device_s/serve_score/b64/k50", {})
    steady = [o["z"] for o in seen if o["z"] is not None]
    good = b64 is not None and b64["last_mfu"] is not None
    ok &= good
    print(f"obs: score/b64 device ms from the profiler: EWMA "
          f"{b64['ewma_s'] * 1e3 if b64 else float('nan'):.4f}, p50 "
          f"{(h64.get('p50') or 0.0) * 1e3:.4f} (start event before the "
          f"store call to the fetch's event: copy-in, replay, output clone) "
          f"vs phase 12b's replay {replays.get(('score', 64), 0.0):.4f} ms "
          f"(20 replays back to back), same run; prof/drift findings "
          f"{len(prof.findings())}, largest z in the stream "
          f"{max(steady) if steady else None} ({smi}) "
          f"{'ok' if good else 'FAIL'}", flush=True)
    return launches, ok


def profiled_sharded(torch, np, zoo, hot_loop, run_dir):
    """Phase 13b: the sharded engine's profiler: each k=5000/1000 score
    dispatch's FLOPs at the request's own k under the bucket's "dyn" key,
    one score_adaptive dispatch's at its rows' k_used, whose mean the key's
    ``ewma_k_used`` equals. Returns ok."""
    from iwae_replication_project_tpu_torch.data import load_dataset
    from iwae_replication_project_tpu_torch.serving.sharded import (
        ShardedScoreEngine)
    from iwae_replication_project_tpu_torch.utils.flops import (
        serving_score_flops_per_row)

    eng = ShardedScoreEngine(run_dir, k_chunk=SHARDED_KC,
                             k_max=SHARDED_KMAX, max_batch=SHARDED_BATCH,
                             timeout_s=None)
    ds = load_dataset(zoo.get(PRESET).dataset, data_dir="data")
    data = ds.x_test.reshape(len(ds.x_test), -1).astype(np.float32)
    eng.warmup()
    seen = _watch_observe(eng.profiler)
    torch.cuda.synchronize()
    hot_loop.reset_launch_counts()
    i, ks = 0, []
    for k, n in OBS_SHARDED:
        x = data[i:i + n]
        i += n
        eng.score(x, k)
        ks.append((k, n))
    x = data[i:i + SHARDED_BATCH]
    out = eng.score_adaptive(x, SHARDED_KMAX, target_se=0.5)
    torch.cuda.synchronize()
    launches = hot_loop.launch_counts()[hot_loop.KERNEL]
    snap = eng.profiler.snapshot()
    scores = [o for o in seen if o["program"] == "serve_score"]
    flops_ok = len(scores) == len(ks) and all(
        o["k_class"] == "dyn" and o["flops"] == serving_score_flops_per_row(
            eng.cfg, k) * n for o, (k, n) in zip(scores, ks))
    ada = [o for o in seen if o["program"] == "serve_score_adaptive"]
    k_used = out[:, 2]
    doc = snap["keys"].get(ada[0]["key"], {}) if ada else {}
    ada_ok = len(ada) == 1 and ada[0]["samples"] == float(k_used.sum()) \
        and doc.get("ewma_k_used") == float(k_used.sum()) / len(k_used) \
        and ada[0]["flops"] == sum(serving_score_flops_per_row(
            eng.cfg, int(ku)) for ku in k_used)
    ok = flops_ok and ada_ok
    print(f"obs: sharded engine, {len(ks)} score dispatches at k "
          f"{[k for k, _ in ks]} (rows {[n for _, n in ks]}): FLOPs at the "
          f"request k under 'dyn' {flops_ok}; one score_adaptive dispatch of "
          f"{len(k_used)} rows at cap {SHARDED_KMAX}: k_used "
          f"{[int(v) for v in k_used]}, ewma_k_used "
          f"{doc.get('ewma_k_used')} = mean k_used "
          f"{float(k_used.mean())}: {ada_ok}; keys "
          f"{ {k: v['count'] for k, v in snap['keys'].items()} }; B1 "
          f"launches {launches} {'ok' if ok else 'FAIL'}", flush=True)
    eng.stop()
    return ok


def _http_get(port, path):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=60) as r:
            return r.status, r.headers.get("Content-Type", ""), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type", ""), e.read()


def _cli(run_dir, args):
    """The serving CLI from the run dir, stdin held open, and its first
    JSON line."""
    root = str(Path(__file__).resolve().parent)
    proc = subprocess.Popen(
        [sys.executable, "-m", "iwae_replication_project_tpu_torch.serving",
         "--checkpoint", run_dir, "--metrics-port", "0"] + args,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=root, env=dict(os.environ))
    ready = None
    while ready is None:
        line = proc.stdout.readline()
        if not line:
            break
        if line.startswith("{"):
            ready = json.loads(line)
    return proc, ready


def _cli_exit(proc):
    """Close stdin, wait; (exit code, the rest of stdout, stderr's tail)."""
    try:
        proc.stdin.close()
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
            rc = None
    return rc, proc.stdout.read(), proc.stderr.read()[-4000:]


def metrics_page(np, run_dir, tmp):
    """Phase 13c: the CLI's tier mode with ``--replicas 2 --port 0
    --metrics-port 0`` and a ``--client`` burst: /metrics, /healthz,
    /traces and /prof; the trace dump against the tier; then engine mode
    with ``--metrics-port 0 --interactive``: its page carries the prof_*
    and span_serve_* families. Both exit 0 on stdin EOF. Returns ok."""
    root = str(Path(__file__).resolve().parent)
    t0 = time.perf_counter()
    proc, ready = _cli(run_dir, ["--replicas", "2", "--port", "0"])
    checks = {}
    try:
        if ready is not None:
            port, mport = ready["tier"]["port"], ready["metrics_port"]
            client = subprocess.run(
                [sys.executable, "-m",
                 "iwae_replication_project_tpu_torch.serving", "--client",
                 f"127.0.0.1:{port}", "--requests", "40"],
                capture_output=True, text=True, timeout=300, cwd=root)
            checks["client"] = client.returncode == 0
            status, ctype, body = _http_get(mport, "/metrics")
            page = body.decode()
            checks["metrics"] = status == 200 and ctype.startswith(
                "text/plain; version=0.0.4") and \
                "iwae_router_completed_total" in page and "iwae_slo_" in page
            status, _, body = _http_get(mport, "/healthz")
            checks["healthz"] = status == 200 and json.loads(body)["ok"]
            status, _, body = _http_get(mport, "/traces")
            checks["traces"] = status == 200 and \
                "traceEvents" in json.loads(body)
            status, _, body = _http_get(mport, "/prof")
            profs = json.loads(body).get("profilers", []) \
                if status == 200 else []
            checks["prof"] = len(profs) == 2 and all(
                p["peaks"]["peak_flops"] == 989e12 for p in profs)
            out = os.path.join(tmp, "traces.json")
            dump = subprocess.run(
                [sys.executable, "-m",
                 "iwae_replication_project_tpu_torch.telemetry.trace_cli",
                 f"127.0.0.1:{port}", "--out", out],
                capture_output=True, text=True, timeout=120, cwd=root)
            checks["trace_cli"] = dump.returncode == 0 and \
                "traceEvents" in json.loads(Path(out).read_text())
            n_events = len(json.loads(Path(out).read_text())["traceEvents"]) \
                if checks["trace_cli"] else None
    finally:
        rc, _, err = _cli_exit(proc)
    checks["tier_exit"] = rc == 0
    ok = ready is not None and all(checks.values())
    print(f"obs: cli --checkpoint RUN_DIR --replicas 2 --port 0 "
          f"--metrics-port 0 and --client --requests 40: "
          f"{checks}; /prof documents "
          f"{len(profs) if ready else None}, the trace dump's events "
          f"{n_events if ready else None}; "
          f"{time.perf_counter() - t0:.1f}s {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        print(err, flush=True)

    t0 = time.perf_counter()
    proc, ready = _cli(run_dir, ["--interactive"])
    echecks = {}
    try:
        if ready is not None:
            mport = ready["metrics_port"]
            row = (np.random.RandomState(17).rand(784) > 0.5).astype(
                np.float32).tolist()
            for _ in range(2):
                proc.stdin.write(json.dumps({"op": "score", "x": [row]})
                                 + "\n")
                proc.stdin.flush()
                echecks.setdefault("results", True)
                echecks["results"] &= "result" in json.loads(
                    proc.stdout.readline())
            page = _http_get(mport, "/metrics")[2].decode()
            echecks["families"] = "iwae_prof_" in page and \
                "iwae_span_serve_" in page
            status, _, body = _http_get(mport, "/prof")
            echecks["prof"] = status == 200 and \
                len(json.loads(body)["profilers"]) == 1
    finally:
        rc, _, err = _cli_exit(proc)
    echecks["engine_exit"] = rc == 0
    good = ready is not None and all(echecks.values())
    ok &= good
    print(f"obs: cli --checkpoint RUN_DIR --metrics-port 0 --interactive: "
          f"{echecks}; {time.perf_counter() - t0:.1f}s "
          f"{'ok' if good else 'FAIL'}", flush=True)
    if not good:
        print(err, flush=True)
    return ok


def spans_on_the_timeline(torch, np, run_dir, tmp):
    """Phase 13d: one score dispatch of a fresh engine (its program's first
    admission: the eager warm-up, the capture, a replay) under
    ``utils.profiling.trace``: the Chrome trace holds the
    ``serve/dispatch/score`` range and B1's kernel. Returns ok."""
    from iwae_replication_project_tpu_torch.serving.engine import (
        ServingEngine)
    from iwae_replication_project_tpu_torch.utils import compile_cache as cc
    from iwae_replication_project_tpu_torch.utils.profiling import trace

    with cc.isolated_aot_registry(budget_bytes=None):
        eng = ServingEngine(run_dir, timeout_s=None)
        x = (np.random.RandomState(18).rand(1, 784) > 0.5).astype(np.float32)
        with trace(os.path.join(tmp, "trace")) as tr:
            eng.score(x)
            torch.cuda.synchronize()
    events = json.loads(Path(tr.path).read_text())["traceEvents"]
    ranges = [e for e in events if e.get("name") == "serve/dispatch/score"]
    b1 = [e for e in events if "hot_loop_fwd" in str(e.get("name", ""))
          and e.get("cat") == "kernel"]
    ok = bool(ranges) and bool(b1)
    print(f"obs: trace of one score dispatch: {len(events)} events, "
          f"'serve/dispatch/score' ranges {len(ranges)}, B1 kernel events "
          f"{len(b1)} ({b1[0]['name'][:60] if b1 else None}, "
          f"{b1[0].get('dur') if b1 else None} us) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def driver_spans():
    """Phase 13e: the ``span/train*`` and ``span/eval*`` histograms phase
    7's driver run left in the process registry. Returns ok."""
    from iwae_replication_project_tpu_torch.telemetry.registry import (
        get_registry)

    hists = get_registry().snapshot()["histograms"]
    names = sorted(n for n in hists if n.startswith(("span/train",
                                                     "span/eval")))
    for n in names:
        print(f"obs: {n}: count {hists[n]['count']}, p50 "
              f"{hists[n]['p50'] * 1e3:.3f} ms (host)", flush=True)
    ok = {"span/train/stage", "span/eval/statistics"} <= set(names)
    print(f"obs: {len(names)} driver span names {'ok' if ok else 'FAIL'}",
          flush=True)
    return ok


def store_bound(after_burst):
    """Phase 13f: C7 after phase 12c's burst: the resident entries' pool
    bytes sum to at most the budget plus the largest entry, and every bill
    is at least its pool bytes. Returns ok."""
    entries = after_burst["entries"]
    pools = [e["pool_bytes"] for e in entries]
    budget = after_burst["budget"]
    held = sum(pools)
    bound_ok = held <= budget + max(pools, default=0)
    bills_ok = all(e["bytes"] >= e["pool_bytes"] for e in entries)
    ok = bound_ok and bills_ok and bool(entries)
    print(f"obs: C7 after phase 12c's burst: {len(entries)} resident "
          f"entries hold {held} B (pool segments + static inputs) under a "
          f"budget of {budget} B (largest entry {max(pools, default=0)} B): "
          f"{bound_ok}; every bill >= its pool bytes: {bills_ok}; "
          f"evictions {after_burst['evictions']}, readmits "
          f"{after_burst['readmits']} {'ok' if ok else 'FAIL'}", flush=True)
    return ok


def observability(torch, np, zoo, hot_loop, run_dir, replays, after_burst,
                  smi, tmp):
    """Phase 13: (a)-(f) above. Returns (B1 launches of 13a, ok)."""
    t0 = time.perf_counter()
    launches, ok = profiled_serving(torch, np, hot_loop, run_dir, replays,
                                    smi)
    ok &= profiled_sharded(torch, np, zoo, hot_loop, run_dir)
    ok &= metrics_page(np, run_dir, tmp)
    ok &= spans_on_the_timeline(torch, np, run_dir, tmp)
    ok &= driver_spans()
    ok &= store_bound(after_burst)
    print(f"obs: phase 13 {time.perf_counter() - t0:.1f}s "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return launches, ok


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        return fail(f"cannot import torch/numpy: {e}")
    if not torch.cuda.is_available():
        return fail("no CUDA device: this smoke test runs on the GPU")
    here = Path(__file__).resolve().parent
    try:
        import iwae_replication_project_tpu_torch as port
        from iwae_replication_project_tpu_torch import zoo
        from iwae_replication_project_tpu_torch.ops import _kernels, hot_loop
        from iwae_replication_project_tpu_torch.ops import (
            fused_likelihood as fl)
        from iwae_replication_project_tpu_torch.ops import (
            row_invariant as ri)
    except ImportError as e:
        return fail(f"the port package is not beside this script: {e}")
    if Path(port.__file__).resolve().parent.parent != here:
        return fail(f"imported the port from {port.__file__}, not from the "
                    f"checkout at {here}")

    t_start = time.perf_counter()
    smi = nvidia_smi()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"env: torch={torch.__version__} cuda={torch.version.cuda} "
          f"device={torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    try:
        secs = _kernels.build([hot_loop.KERNEL, hot_loop.KERNEL_BWD,
                               fl.KERNEL_FWD, fl.KERNEL_BWD,
                               ri.KERNEL_DENSE, ri.KERNEL_SUM])
    except RuntimeError as e:
        return fail(str(e))
    for name, s in secs.items():
        print(f"build: {name} {s:.2f}s", flush=True)
        log = _kernels.build_log.get(name, (0.0, ""))[1]
        for ln in log.splitlines():
            if any(w in ln for w in ("entry function", "registers", "spill",
                                     "smem")):
                print(f"build: ptxas {ln.strip()}", flush=True)

    record, ok, b1_times = check_hot_loop(torch, hot_loop)
    if not ok:
        return fail("a kernel disagrees with its plain version")
    record_bwd, ok = check_hot_loop_bwd(torch, hot_loop,
                                        _kernels.load(hot_loop.KERNEL_BWD))
    if not ok:
        return fail("the backward kernel disagrees with its plain version")
    fll_records, ok = check_fused_ll(torch, fl, (
        _kernels.load(fl.KERNEL_FWD), _kernels.load(fl.KERNEL_BWD)))
    if not ok:
        return fail("a fused-likelihood kernel disagrees with its plain "
                    "version")
    fll_launches, ok = fused_ll_path(torch, fl, hot_loop)
    if not ok:
        return fail("the fused_bernoulli_ll path failed")
    for rec in fll_records:
        rec["launches"] = fll_launches[rec["name"]]
    row_records, ok = check_row_kernels(torch, ri)
    if not ok:
        return fail("a row-invariant kernel disagrees with its plain "
                    "version")

    launches, ok = serve(torch, np, zoo, hot_loop)
    if not ok:
        return fail("the serving phase failed")
    record["launches"] = launches[hot_loop.KERNEL]
    for rec in row_records:
        rec["launches"] = launches[rec["name"]]

    train_launches, state, ok = train(torch, np, zoo, hot_loop)
    if not ok:
        return fail("the training phase failed")
    record_bwd["launches"] = train_launches[hot_loop.KERNEL_BWD]
    ok, _, _ = graph_vs_eager(torch, zoo, hot_loop)
    if not ok:
        return fail("the graph replay of the step differs from the eager "
                    "step")
    if not wide_block(torch, np, hot_loop):
        return fail("the 256-wide bf16 block did not take the reference "
                    "path")

    if not evaluate(torch, np, zoo, hot_loop, state,
                    b1_times[("bf16", "eval", 500)]):
        return fail("the evaluation phase failed")

    with tempfile.TemporaryDirectory() as tmp:
        _, ok, run_dir = driver(torch, np, zoo, hot_loop, tmp)
        if not ok:
            return fail("the driver phase failed")
        nccl_launches, ok = parallel_nccl(torch, np, zoo, hot_loop, tmp)
        if not ok:
            return fail("the NCCL mesh phase failed")
        gloo_launches, ok = parallel_gloo(torch, np, hot_loop, tmp)
        if not ok:
            return fail("the gloo mesh phase failed")
        if not parallel_cli(np, tmp):
            return fail("the mesh command line failed")
        facade_launches, ok = facade(torch, np, hot_loop, tmp)
        if not ok:
            return fail("the facade phase failed")
        sharded_b1, ok = sharded_serve(
            torch, np, zoo, hot_loop, run_dir,
            b1_times[("bf16", "sharded-b8", 8)])
        if not ok:
            return fail("the sharded serving phase failed")
        sharded_gloo_launches, ok = sharded_gloo(torch, np, zoo, hot_loop,
                                                 run_dir, tmp)
        if not ok:
            return fail("the sharded gloo phase failed")
        if not sharded_cli(np, run_dir):
            return fail("the serving command line from a checkpoint failed")
        tier_b1, tier_rows, ok = serving_tier(torch, np, hot_loop, run_dir)
        if not ok:
            return fail("the serving tier phase failed")
        if not tier_cli(run_dir):
            return fail("the serving CLI's tier and client modes failed")
        if not bucket_invariance(torch, np, run_dir):
            return fail("a served row changed its bits with its bucket")
        bills, replays, ok = store_on_the_flagship(torch, np, run_dir)
        if not ok:
            return fail("the executable store's graphs failed")
        mm_b1, mm_rows, after_burst, ok = multi_model_tier(torch, np,
                                                           hot_loop, bills)
        if not ok:
            return fail("the multi-model tier phase failed")
        as_b1, ok = autoscaler(torch, np, hot_loop, run_dir)
        if not ok:
            return fail("the autoscaler phase failed")
        if not multi_model_cli(bills):
            return fail("the CLI's --models --autoscale tier mode failed")
        obs_b1, ok = observability(torch, np, zoo, hot_loop, run_dir,
                                   replays, after_burst, smi, tmp)
        if not ok:
            return fail("the observability phase failed")
    sharded_launches = {hot_loop.KERNEL: sharded_b1}
    for rec in (record, record_bwd):
        rec["launches_by_path"] = {
            "parallel_nccl_1x1": nccl_launches.get(rec["name"], 0),
            "parallel_gloo_2x2": gloo_launches.get(rec["name"], 0),
            "facade_logits_bf16": facade_launches.get(rec["name"], 0),
            "sharded_serve_1x1": sharded_launches.get(rec["name"], 0),
            "sharded_serve_gloo_2x2": sharded_gloo_launches.get(rec["name"],
                                                                0),
            "serving_tier": tier_b1 if rec is record else 0,
            "multi_model_tier": mm_b1 if rec is record else 0,
            "autoscaler": as_b1 if rec is record else 0,
            "observability": obs_b1 if rec is record else 0}
    for rec in row_records:
        rec["launches_by_path"] = {"serving_tier": tier_rows[rec["name"]],
                                   "multi_model_tier": mm_rows[rec["name"]]}

    print(f"total: {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": [record, record_bwd] + fll_records
                      + row_records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

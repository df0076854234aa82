#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``iwae_replication_project_tpu_torch``) on the card in
phases, one line per phase, and exits non-zero on the first failure:

1. the card's name and power limit (nvidia-smi), torch/CUDA versions and the
   TF32 flags (both set False: the plain versions must run in full fp32);
2. builds every CUDA kernel of the serving path from ``csrc/`` (one ``nvcc``
   per source, all started together) and prints the build time and ptxas's
   register/shared-memory report;
3. holds each kernel against its plain PyTorch version on the card at the
   serving shapes (k=50 x B in {1, 7, 64}), an odd shape and an eval-like
   shape (k=250, B=500), in fp32 and bf16, within the stated tolerances, and
   times kernel and plain version with CUDA events beside the kernel's bound;
4. serves the flagship preset ``northstar-iwae-2l-k50`` at full width (fresh
   weights from the preset's seed, synthetic binary rows from a seed) through
   the pipelined engine: warmup, then a ragged stream of score requests plus
   a few encode and decode requests; prints latency and throughput, proves
   the kernel launched during that run, holds a handful of rows against a
   ``kernel_path="reference"`` engine of the same weights and seeds, and
   checks that every result is finite;
5. prints the kernels' JSON record and, last, the contract line
   ``{"ok": true, "device": {...}}``.

Without a CUDA device, or run outside a checkout of the repository, it exits
non-zero and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
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

#: H100 SXM peaks (NVIDIA data sheet, dense): fp32 on the CUDA cores, bf16 on
#: the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12

FLAGSHIP = dict(h1=100, hid=200, d=784)
PRESET = "northstar-iwae-2l-k50"


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
    """Mean device time of one call over `iters` back-to-back calls, after
    warming up, measured with CUDA events."""
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
    ok)."""
    shapes = [("serve", 50, 1, FLAGSHIP), ("serve", 50, 7, FLAGSHIP),
              ("serve", 50, 64, FLAGSHIP), ("odd", 13, 17, FLAGSHIP),
              ("odd-widths", 3, 5, dict(h1=37, hid=70, d=130)),
              ("eval", 250, 500, FLAGSHIP)]
    ok = True
    worst = 0.0
    main = None
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
            if tag in ("serve", "eval"):
                ms = time_ms(lambda: hot_loop.fused_forward(
                    *args, compute_dtype=cd), torch)
                plain = time_ms(lambda: hot_loop._reference_impl(
                    *args, compute_dtype=cd), torch)
                bound, by = hot_loop_bound_ms(k, b, w["h1"], w["hid"],
                                              w["d"], dtype)
                line += (f" | kernel_ms={ms:.4f} plain_ms={plain:.4f} "
                         f"bound_ms={bound:.5f} ({by})")
                if dtype == "bf16" and tag == "serve" and b == 64:
                    main = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                bound_by=by)
            print(line, flush=True)
    record = {"name": "hot_loop_fwd", "route": "cuda",
              "source": "iwae_replication_project_tpu_torch/csrc/"
                        "hot_loop_fwd.cu",
              "replaces": "iwae_replication_project_tpu/ops/hot_loop.py:633",
              "launches": None, "max_abs_err": worst, "ms": main["ms"],
              "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
              "bound_by": main["bound_by"], "library_ms": None}
    return record, ok


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
    (launches during the served run, ok)."""
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
          f"score kernel stamps = {sorted(set(paths.values()))}", flush=True)
    ok = True
    if launches <= 0:
        ok = False
        print("FAIL: the kernel was not launched by the served run")
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
    # encode/decode never touch the kernel: the two engines differ only in
    # how rows were batched (cuBLAS may pick another algorithm per batch
    # size), so latents and probabilities agree to well under 1e-2
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
    return launches, ok and side_ok


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
        secs = _kernels.build([hot_loop.KERNEL])
    except RuntimeError as e:
        return fail(str(e))
    for name, s in secs.items():
        print(f"build: {name} {s:.2f}s", flush=True)
        log = _kernels.build_log.get(name, (0.0, ""))[1]
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "smem" in ln:
                print(f"build: ptxas {ln.strip()}", flush=True)

    record, ok = check_hot_loop(torch, hot_loop)
    if not ok:
        return fail("a kernel disagrees with its plain version")

    launches, ok = serve(torch, np, zoo, hot_loop)
    if not ok:
        return fail("the serving phase failed")
    record["launches"] = launches

    print(f"total: {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": [record]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

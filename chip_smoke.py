#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``iwae_replication_project_tpu_torch``) on the card in
phases, one line per phase, and exits non-zero on the first failure:

1. the card's name and power limit (nvidia-smi), torch/CUDA versions and the
   TF32 flags (both set False: the plain versions must run in full fp32);
2. builds every CUDA kernel of the serving and training paths from
   ``csrc/`` (one ``nvcc`` per source, all started together) and prints the
   build times and ptxas's register/shared-memory report;
3. holds each kernel against its plain PyTorch version on the card, in fp32
   and bf16, within the stated tolerances, and times kernel and plain version
   with CUDA events beside the kernel's bound: the forward (``hot_loop_fwd``)
   at the serving shapes (k=50 x B in {1, 7, 64}), an odd shape and an
   eval-like shape (k=250, B=500); the backward (``hot_loop_bwd``), per
   output, at the train shape (k=50, B=100), the eval chunk, an odd shape and
   odd widths, and bitwise across two launches;
4. serves the flagship preset ``northstar-iwae-2l-k50`` at full width (fresh
   weights from the preset's seed, synthetic binary rows from a seed) through
   the pipelined engine: warmup, then a ragged stream of score requests plus
   a few encode and decode requests; prints latency and throughput, proves
   the kernel launched during that run, holds a handful of rows against a
   ``kernel_path="reference"`` engine of the same weights and seeds, and
   checks that every result is finite;
5. trains the same preset at full width with ``zoo.train`` for two Burda
   stages (1 + 3 passes over the synthetic set: 40 steps of k=50, B=100,
   bf16): per-pass losses (finite, falling), ms per step, a breakdown of one
   step, launches of both kernels (each equal to the step count); then holds
   a step's per-leaf gradients against a ``hot_loop_path="reference"`` run
   on the same draws, and runs one DReG step at 1-layer width, which must
   launch the backward kernel twice;
6. prints the kernels' JSON record and, last, the contract line
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

FLAGSHIP = dict(h1=100, hid=200, d=784)
PRESET = "northstar-iwae-2l-k50"
TRAIN_K, TRAIN_B = 50, 100


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


def check_hot_loop_bwd(torch, hot_loop):
    """Phase 3b: the backward kernel vs its plain version, per output, and
    bitwise across two launches; returns (record for the JSON line, ok)."""
    shapes = [("train", TRAIN_K, TRAIN_B, FLAGSHIP), ("odd", 13, 17, FLAGSHIP),
              ("odd-widths", 3, 5, dict(h1=37, hid=70, d=130)),
              ("eval", 250, 500, FLAGSHIP)]
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
            if tag in ("train", "eval"):
                ms = time_ms(lambda: hot_loop.fused_backward(
                    *args, g, compute_dtype=cd), torch)
                plain = time_ms(lambda: hot_loop._bwd_plain(
                    *args, g, compute_dtype=cd), torch)
                bound, by = hot_loop_bwd_bound_ms(k, b, w["h1"], w["hid"],
                                                  w["d"], dtype)
                line += (f" | kernel_ms={ms:.4f} plain_ms={plain:.4f} "
                         f"bound_ms={bound:.5f} ({by})")
                if dtype == "bf16" and tag == "train":
                    main = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                bound_by=by)
            print(line, flush=True)
            del args, got, again, want
    record = {"name": "hot_loop_bwd", "route": "cuda",
              "source": "iwae_replication_project_tpu_torch/csrc/"
                        "hot_loop_bwd.cu",
              "replaces": "iwae_replication_project_tpu/ops/hot_loop.py:698",
              "launches": None, "max_abs_err": worst, "ms": main["ms"],
              "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
              "bound_by": main["bound_by"], "library_ms": None}
    return record, ok


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
    leaves = state.optimizer.param_groups[0]["params"]
    for p in leaves:
        p.grad = torch.zeros_like(p)
    adam_ms = time_ms(lambda: state.optimizer.step(), torch, iters=10)
    state.optimizer.zero_grad(set_to_none=True)
    return step_ms, fwd_ms, bwd_ms, adam_ms


def train(torch, np, zoo, hot_loop):
    """Phase 5: the flagship preset trained at full width through the
    kernels. Returns ({kernel: launches during the training run}, ok)."""
    import dataclasses

    from iwae_replication_project_tpu_torch.data import load_dataset
    from iwae_replication_project_tpu_torch.models.iwae import ModelConfig
    from iwae_replication_project_tpu_torch.objectives import (
        ObjectiveSpec, objective_value_and_grad)
    from iwae_replication_project_tpu_torch.training import train_step as ts
    from iwae_replication_project_tpu_torch.utils.tree import tree_leaves

    hot_loop.reset_launch_counts()
    t0 = time.perf_counter()
    state, history = zoo.train(PRESET, n_stages=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hot_loop.launch_counts()
    ok = True
    losses = [v for h in history for v in h["pass_losses"]]
    steps = state.step
    for h in history:
        print(f"train: stage {h['stage']} lr={h['learning_rate']:.2e} "
              f"{h['objective']} k={h['k']} passes={h['passes']} "
              f"steps={h['steps']} pass_losses="
              f"{[round(v, 4) for v in h['pass_losses']]} "
              f"train_s={h['train_seconds']:.3f} "
              f"grad_snr_enc={h.get('diag/grad_snr_enc', float('nan')):.4f} "
              f"grad_snr_dec={h.get('diag/grad_snr_dec', float('nan')):.4f}",
              flush=True)
    last = history[-1]
    per_step_host = last["train_seconds"] / (last["steps"]
                                             - history[-2]["steps"])
    print(f"train: {steps} steps in {wall:.3f}s (zoo.train, data and state "
          f"set-up included); ms per step over stage {last['stage']} (host "
          f"clock, {last['passes']} passes, one fetch) = "
          f"{per_step_host * 1e3:.4f}", flush=True)
    print(f"train: launches during the run {launches} (steps={steps})",
          flush=True)
    if not (launches[hot_loop.KERNEL] == steps
            and launches[hot_loop.KERNEL_BWD] == steps):
        ok = False
        print("FAIL: B1 and B2 must each launch once per train step")
    finite = bool(np.isfinite(losses).all())
    falling = losses[-1] < losses[0]
    print(f"train: losses finite={finite} first={losses[0]:.4f} "
          f"last={losses[-1]:.4f} falling={falling}", flush=True)
    ok &= finite and falling

    # one step's time and its parts, on the trained state
    cfg = zoo.get(PRESET)
    model_cfg = cfg.model_config("cuda")
    ds = load_dataset(cfg.dataset, data_dir=cfg.data_dir)
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
    return launches, ok and dreg_ok


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
        secs = _kernels.build([hot_loop.KERNEL, hot_loop.KERNEL_BWD])
    except RuntimeError as e:
        return fail(str(e))
    for name, s in secs.items():
        print(f"build: {name} {s:.2f}s", flush=True)
        log = _kernels.build_log.get(name, (0.0, ""))[1]
        for ln in log.splitlines():
            if any(w in ln for w in ("entry function", "registers", "spill",
                                     "smem")):
                print(f"build: ptxas {ln.strip()}", flush=True)

    record, ok = check_hot_loop(torch, hot_loop)
    if not ok:
        return fail("a kernel disagrees with its plain version")
    record_bwd, ok = check_hot_loop_bwd(torch, hot_loop)
    if not ok:
        return fail("the backward kernel disagrees with its plain version")

    launches, ok = serve(torch, np, zoo, hot_loop)
    if not ok:
        return fail("the serving phase failed")
    record["launches"] = launches

    train_launches, ok = train(torch, np, zoo, hot_loop)
    if not ok:
        return fail("the training phase failed")
    record_bwd["launches"] = train_launches[hot_loop.KERNEL_BWD]

    print(f"total: {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": [record, record_bwd]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The hot-loop pair (B1, B2) on one NVIDIA GPU, beyond chip_smoke.py's one
pass per shape:

    python3 scripts/torch_hot_loop_profile.py [--seeds 6]

1. Rounding: at the eval chunk (k=250, B=500, the flagship's widths, bf16)
   how many rows move by more than chip_smoke's bf16 tolerance when only
   the summation order of the hidden layers changes. It compares the plain
   version with a plain version whose y1, y2 pre-activations are summed in
   float64 and rounded once. Then B1 against the plain version over
   `--seeds` draws: rows out of tolerance and the worst error, for B1 as
   built and for a copy built without its exact-rounding fixups
   (``-DHOT_LOOP_FWD_EXACT=false``, into ``_build/``).
2. Times of B1 (as built and without the fixups) and B2 in bf16 at the
   serve (k=50, B=64), train (k=50, B=100) and eval (k=250, B=500) shapes,
   as chip_smoke.py takes them: CUDA events around 20 calls back to back,
   and around a CUDA-graph replay of 20 calls (device time), with each
   one's bound share.

Prints one line per result and, last, one JSON object with all of them.
Without a CUDA device it exits non-zero. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402  (the inputs, timer and bounds)


def b1_without_fixups(torch):
    """B1's bf16 path built with ``-DHOT_LOOP_FWD_EXACT=false``: a function
    of ``fused_forward``'s bf16 arguments that launches it."""
    from iwae_replication_project_tpu_torch.ops import _kernels
    from iwae_replication_project_tpu_torch.ops import hot_loop as thl

    path = _kernels.library_path(thl.KERNEL)
    path = path.with_name(path.stem + "-inexact.so")
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_kernels.nvcc_path(), *_kernels.NVCC_FLAGS,
                        "-DHOT_LOOP_FWD_EXACT=false", "-o", str(path),
                        str(_kernels.SRC_DIR / f"{thl.KERNEL}.cu")],
                       check=True, capture_output=True)
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in _kernels.SIGNATURES[thl.KERNEL].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes

    def forward(h1, w1, b1, w2, b2, w3, b3, x):
        k, b, h = h1.shape
        hid, d = w1.shape[1], w3.shape[1]
        out = torch.empty((k, b), dtype=torch.float32, device=h1.device)
        scratch = torch.empty(lib.hot_loop_fwd_scratch_bytes(h, hid, d, 1),
                              dtype=torch.uint8, device=h1.device)
        rc = _kernels.launch(h1.device, lib.hot_loop_fwd, *(
            t.data_ptr() for t in (h1, w1, b1, w2, b2, w3, b3, x, out,
                                   scratch)), k * b, b, h, hid, d, 1)
        if rc != 0:
            raise RuntimeError(f"launch failed with CUDA error {rc}")
        return out
    return forward


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=6)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    from iwae_replication_project_tpu_torch.ops import hot_loop as thl
    from iwae_replication_project_tpu_torch.ops.distributions import softplus

    torch.backends.cuda.matmul.allow_tf32 = False
    bf = torch.bfloat16
    atol, rtol = cs.TOL["bf16"]
    out = {"device": cs.nvidia_smi()}
    print(out["device"], flush=True)

    def op(t):
        return t.to(bf).float()

    def exact_hidden(h1, w1, b1, w2, b2, w3, b3, x):
        y1 = torch.tanh((op(h1).double() @ op(w1).double()).float() + b1)
        y2 = torch.tanh((op(y1).double() @ op(w2).double()).float() + b2)
        logits = op(y2) @ op(w3) + b3
        return torch.sum(x[None] * logits - softplus(logits), dim=-1)

    def out_of_tol(got, want):
        err = (got - want).abs()
        return int((err > atol + rtol * want.abs()).sum()), float(err.max())

    inexact = b1_without_fixups(torch)
    rows = {"order": [0, 0.0], "kernel": [0, 0.0], "inexact": [0, 0.0]}
    for seed in range(args.seeds):
        a = cs.hot_loop_inputs(torch, 250, 500, 100, 200, 784,
                               seed=1000 + seed)
        want = thl._reference_impl(*a, compute_dtype=bf)
        for key, got in (("order", exact_hidden(*a)),
                         ("kernel", thl.fused_forward(*a, compute_dtype=bf)),
                         ("inexact", inexact(*a))):
            bad, worst = out_of_tol(got, want)
            rows[key][0] += bad
            rows[key][1] = max(rows[key][1], worst)
        del a, want
    n = 125000 * args.seeds
    print(f"rounding: hidden sums in float64 vs the plain version: "
          f"{rows['order'][0]} of {n} rows out of tolerance, worst "
          f"{rows['order'][1]:.3e} nats; B1 bf16 vs the plain version: "
          f"{rows['kernel'][0]} of {n}, worst {rows['kernel'][1]:.3e}; "
          f"B1 without the fixups: {rows['inexact'][0]} of {n}, worst "
          f"{rows['inexact'][1]:.3e}", flush=True)
    out["rounding"] = {"rows": n, "order_out_of_tol": rows["order"][0],
                       "order_worst": rows["order"][1],
                       "b1_out_of_tol": rows["kernel"][0],
                       "b1_worst": rows["kernel"][1],
                       "b1_without_fixups_out_of_tol": rows["inexact"][0],
                       "b1_without_fixups_worst": rows["inexact"][1]}

    out["times"] = {}
    for tag, k, b in (("serve", 50, 64), ("train", 50, 100),
                      ("eval", 250, 500)):
        a = cs.hot_loop_inputs(torch, k, b, 100, 200, 784, seed=7)
        g = torch.randn((k, b), generator=torch.Generator().manual_seed(8)
                        ).cuda()
        fb, _ = cs.hot_loop_bound_ms(k, b, 100, 200, 784, "bf16")
        bb, _ = cs.hot_loop_bwd_bound_ms(k, b, 100, 200, 784, "bf16")
        rec = out["times"][tag] = {}
        for name, fn, bound in (
                ("b1", lambda: thl.fused_forward(*a, compute_dtype=bf), fb),
                ("b1_without_fixups", lambda: inexact(*a), fb),
                ("b2", lambda: thl.fused_backward(*a, g, bf), bb)):
            ms, graph = cs.time_ms(fn, torch), cs.device_ms(fn, torch)
            rec[name] = {"ms": ms, "graph_ms": graph,
                         "bound_share": bound / ms,
                         "graph_bound_share": bound / graph}
            print(f"time {tag} k={k} B={b} bf16 {name}: {ms:.4f} ms back "
                  f"to back ({bound / ms:.2%} of bound), graph {graph:.4f} "
                  f"ms ({bound / graph:.2%})", flush=True)
        del a, g
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the fused Bernoulli log-likelihood's kernels (B3, B4) spend their
time on one NVIDIA GPU:

    python3 scripts/torch_fused_ll_profile.py [--iters 10]

For the flagship's last layer (H=200, D=784, fp32) at the train shape
(k=50, B=100) and the eval chunk (k=250, B=500), a torch.profiler trace of
`--iters` forward and backward calls (after a warm-up) gives the device time
of each CUDA kernel a call launches: B3's weight prep and row kernel; B4's
weight prep, row phase, weight-gradient phase and the sum of its row
splits. Beside each: the mean microseconds per call and the share of the
call's device time. The inputs are chip_smoke.py's (`fll_inputs`, seed 300
and 301).

Prints one line per kernel and shape and, last, one JSON object with all
of them. Without a CUDA device it exits non-zero. It imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402  (the inputs)


def profile_calls(torch, fn, iters: int) -> dict:
    """``{kernel name: device microseconds per call}`` over `iters` calls of
    `fn`."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_time_total > 0:
            name = ev.key.replace("(anonymous namespace)::", "")
            name = name.replace("void ", "").split("(")[0]
            out[name] = out.get(name, 0.0) + ev.device_time_total / iters
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    from iwae_replication_project_tpu_torch.ops import fused_likelihood as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    result = {"device": torch.cuda.get_device_name(0), "kernels": []}
    for i, (tag, k, b) in enumerate((("train", cs.TRAIN_K, cs.TRAIN_B),
                                     ("eval", 250, 500))):
        h1, w, bias, x, g = cs.fll_inputs(torch, k, b, 200, 784,
                                          seed=300 + i)
        for op, fn in (("fused_ll_fwd",
                        lambda: fl.fused_ll_forward(h1, w, bias, x)),
                       ("fused_ll_bwd",
                        lambda: fl.fused_ll_backward(h1, w, bias, x, g))):
            times = profile_calls(torch, fn, args.iters)
            total = sum(times.values())
            for name, us in sorted(times.items(), key=lambda kv: -kv[1]):
                print(f"{op} {tag} k={k} B={b}: {name} {us:.2f} us per call "
                      f"({us / total:.1%} of {total:.2f} us device time)",
                      flush=True)
                result["kernels"].append(dict(op=op, shape=tag, k=k, b=b,
                                              kernel=name, us=us,
                                              share=us / total))
        del h1, w, bias, x, g
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

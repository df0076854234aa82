#!/usr/bin/env python3
"""Host cost of the hot-loop wrappers (B1 ``fused_forward``, B2
``fused_backward``) and of the two eager programs that call them, on one
NVIDIA GPU, bf16, the flagship's widths:

    python3 scripts/torch_wrapper_host_profile.py [--port-root DIR]

For B1 at the serve (k=50, B=64) and train (k=50, B=100) shapes and B2 at
the train shape: the host time to issue one wrapper call (microseconds,
median of 7 rounds of 200 calls, the device not waited for), the time of
one call with 20 issued back to back (CUDA events; where the host work
outlasts the device work the device waits) and the device time alone (a
CUDA-graph replay of 20 calls). Then B1's host time in parts at the serve
shape: the input checks, the output and scratch allocations, and the C
entry point (its launches). Last, the programs around them, timed as
chip_smoke.py's breakdowns time them: one 64-row score dispatch of the
preset ``northstar-iwae-2l-k50`` (noise already on the card) and one train
step (k=50, B=100) on fresh weights, each as the time of one call with 20
(steps: 10) issued back to back, with its host time.

``--port-root`` imports the port from another checkout (for example the
parent commit, unpacked with ``git archive``), so two versions of the
wrappers are measured by the same code; its kernels build into that
checkout. Prints one line per result and, last, one JSON object. Without a
CUDA device it exits non-zero. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def programs(torch, cs, host_us) -> dict:
    """The score dispatch and the train step, as described above."""
    from iwae_replication_project_tpu_torch import zoo
    from iwae_replication_project_tpu_torch.data import load_dataset
    from iwae_replication_project_tpu_torch.serving.programs import (
        draw_noise, score_rows)
    from iwae_replication_project_tpu_torch.training import train_step as ts

    eng = zoo.serving_engine(cs.PRESET, seed=0, timeout_s=None)
    cfg, _ = eng._kernel_for("score")
    seeds = list(range(64))
    noise = [t.cuda() for t in draw_noise(cfg, "score", 0, seeds, eng.k)]
    x = (torch.rand((64, cfg.x_dim), generator=torch.Generator()
                    .manual_seed(0)) > 0.5).float().cuda()

    def score():
        score_rows(eng._params, cfg, 0, seeds, x, eng.k, noise=noise)

    exp = zoo.get(cs.PRESET)
    model_cfg = exp.model_config("cuda")
    ds = load_dataset(exp.dataset, data_dir=exp.data_dir)
    state = ts.create_train_state(exp.seed, model_cfg,
                                  output_bias=ds.output_bias)
    step = ts.make_train_step(exp.objective_spec(1), model_cfg)
    xt = torch.as_tensor(ds.x_train[:cs.TRAIN_B], dtype=torch.float32).cuda()

    def train():
        step(state, xt)

    return {"score_64": {"ms": cs.time_ms(score, torch),
                         "host_us": host_us(score, torch, 20)},
            "train_step": {"ms": cs.time_ms(train, torch, iters=10),
                           "host_us": host_us(train, torch, 10)}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port-root", default=str(HERE))
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs  # the inputs and timers
    sys.path.insert(0, str(Path(args.port_root).resolve()))
    import torch

    def host_us(fn, torch, iters=200):
        return cs.host_us(fn, torch, iters=iters, rounds=7)

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    from iwae_replication_project_tpu_torch.ops import _kernels
    from iwae_replication_project_tpu_torch.ops import hot_loop as thl

    bf = torch.bfloat16
    out = {"device": cs.nvidia_smi(), "port": str(Path(thl.__file__).parent)}
    print(f"{out['device']}\nport from {out['port']}", flush=True)
    calls = {}
    for name, k, b in (("b1_serve", 50, 64), ("b1_train", 50, 100),
                       ("b2_train", 50, 100)):
        a = cs.hot_loop_inputs(torch, k, b, 100, 200, 784, seed=0)
        g = torch.randn((k, b), generator=torch.Generator().manual_seed(1)
                        ).cuda()
        if name.startswith("b1"):
            def fn():
                thl.fused_forward(*a, compute_dtype=bf)
        else:
            def fn():
                thl.fused_backward(*a, g, compute_dtype=bf)
        calls[name] = {"host_us": host_us(fn, torch),
                       "ms": cs.time_ms(fn, torch),
                       "graph_ms": cs.device_ms(fn, torch)}
        print(f"{name} k={k} B={b}: host_us={calls[name]['host_us']:.2f} "
              f"back_to_back_ms={calls[name]['ms']:.4f} "
              f"graph_ms={calls[name]['graph_ms']:.4f}", flush=True)
    out["calls"] = calls

    # B1's parts at the serve shape
    a = cs.hot_loop_inputs(torch, 50, 64, 100, 200, 784, seed=0)
    dev = a[0].device
    lib = _kernels.load(thl.KERNEL)
    argtypes = _kernels.SIGNATURES[thl.KERNEL][thl.KERNEL][1]
    res = torch.empty((50, 64), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in a] + [res.data_ptr()]
    parts = {"checks": host_us(lambda: thl._check_block(*a), torch),
             "output alloc": host_us(lambda: torch.empty(
                 (50, 64), dtype=torch.float32, device=dev), torch)}
    if argtypes.count(ctypes.c_void_p) == 11:  # a scratch buffer
        nb = lib.hot_loop_fwd_scratch_bytes(100, 200, 784, 1)
        parts["scratch alloc"] = host_us(lambda: torch.empty(
            nb, dtype=torch.uint8, device=dev), torch)
        scratch = torch.empty(nb, dtype=torch.uint8, device=dev)
        ptrs.append(scratch.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    parts["C entry point"] = host_us(lambda: lib.hot_loop_fwd(
        *ptrs, 3200, 64, 100, 200, 784, 1, stream), torch)
    out["b1_serve_parts_us"] = parts
    print("b1_serve parts (host us): " + ", ".join(
        f"{key} {v:.2f}" for key, v in parts.items()), flush=True)
    out["programs"] = programs(torch, cs, host_us)
    for name, rec in out["programs"].items():
        print(f"{name}: back_to_back_ms={rec['ms']:.4f} "
              f"host_us={rec['host_us']:.1f}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

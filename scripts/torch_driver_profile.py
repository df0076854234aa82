#!/usr/bin/env python3
"""Time of the port's training step and of the staged driver around it, on
one NVIDIA GPU, the preset ``northstar-iwae-2l-k50`` at full width (k=50,
B=100, bf16, diagnostics on) on the loaders' synthetic set (10 steps a
pass):

    python3 scripts/torch_driver_profile.py [--port-root DIR]

1. one step, eager and (where the checkout has it) replayed from its CUDA
   graph: CUDA events around a pass, divided by its steps, mean of 5 passes
   after a warm one. With diagnostics on, every step of the set's 10-step
   pass is in the 50-step SNR window; the step is also timed with
   diagnostics off, and over a pass of MNIST's length (the set tiled to 600
   steps, the trailing 50 in the window; mean of 2 passes after a warm
   one), on the graph where the checkout has one;
2. ``run_experiment`` over 4 stages (1 + 3 + 9 + 27 passes): each stage's
   host ms per step (its ``stage_train_seconds`` over its steps: the
   passes and their one fetch);
3. one dispatch of 27 passes (the driver's ``PASS_BLOCK``; a checkout
   without ``epochs_per_call`` runs 27 calls of one pass) on a warm
   state: host ms per step, ending in one fetch;
4. the paper's run (3280 passes of 600 steps, 1,968,000 steps) projected
   at the rate of 3.

``--port-root`` imports the port from another checkout (for example the
parent commit, unpacked with ``git archive``), so two versions are timed by
the same code; its kernels build into that checkout. Prints one line per
result and, last, one JSON object. Without a CUDA device it exits non-zero.
It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
PRESET = "northstar-iwae-2l-k50"
BATCH = 100
PAPER_STEPS = 3280 * 600


def step_ms(torch, te, ts, cfg, model_cfg, ds, graph, diag=True,
            steps=None, passes=5) -> float:
    """Mean CUDA-event ms per step over `passes` passes after a warm one;
    `steps` tiles the set to a pass of that many steps."""
    n = len(ds.x_train) // BATCH * BATCH
    x = torch.as_tensor(ds.x_train[:n].reshape(n, -1),
                        dtype=torch.float32).cuda()
    if steps is not None:
        n = steps * BATCH
        x = x.repeat(-(-n // len(x)), 1)[:n].contiguous()
    kw = {} if graph is None else {"cuda_graph": graph}
    fn = te.make_epoch_fn(cfg.objective_spec(1), model_cfg, n, BATCH,
                          diagnostics=cfg.diagnostics_config() if diag
                          else None, **kw)
    state = ts.create_train_state(cfg.seed, model_cfg,
                                  output_bias=ds.output_bias)
    state, _ = fn(state, x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(passes):
        state, _ = fn(state, x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (passes * n // BATCH)


def block_ms(torch, te, ts, cfg, model_cfg, ds, passes) -> float:
    """Host ms per step of one dispatch of `passes` passes, one fetch."""
    n = len(ds.x_train) // BATCH * BATCH
    x = torch.as_tensor(ds.x_train[:n].reshape(n, -1),
                        dtype=torch.float32).cuda()
    blocks = "epochs_per_call" in inspect.signature(
        te.make_epoch_fn).parameters
    kw = {"epochs_per_call": passes} if blocks else {}
    fn = te.make_epoch_fn(cfg.objective_spec(1), model_cfg, n, BATCH,
                          diagnostics=cfg.diagnostics_config(), **kw)
    state = ts.create_train_state(cfg.seed, model_cfg,
                                  output_bias=ds.output_bias)
    calls = 1 if blocks else passes
    for timed in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = []
        for _ in range(calls):
            state, (out, _) = fn(state, x)
            outs.append(out)
        torch.cat(outs).cpu()
        secs = time.perf_counter() - t0
    return secs * 1e3 / (passes * n // BATCH)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port-root", default=str(HERE),
                    help="checkout whose iwae_replication_project_tpu_torch "
                         "is timed (default: this one)")
    args = ap.parse_args()
    root = Path(args.port_root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this profile runs on the GPU", flush=True)
        return 1
    import iwae_replication_project_tpu_torch as port
    from iwae_replication_project_tpu_torch import zoo
    from iwae_replication_project_tpu_torch.data import load_dataset
    from iwae_replication_project_tpu_torch.experiment import run_experiment
    from iwae_replication_project_tpu_torch.training import epoch as te
    from iwae_replication_project_tpu_torch.training import train_step as ts
    if Path(port.__file__).resolve().parent.parent != root:
        print(f"imported the port from {port.__file__}, not {root}")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{smi}; port from {root}", flush=True)

    cfg = zoo.get(PRESET)
    model_cfg = cfg.model_config("cuda")
    ds = load_dataset(cfg.dataset, data_dir=cfg.data_dir)
    has_graph = "cuda_graph" in inspect.signature(te.make_epoch_fn).parameters
    res = {"root": str(root), "device": smi,
           "step_eager_ms": step_ms(torch, te, ts, cfg, model_cfg, ds,
                                    False if has_graph else None),
           "step_graph_ms": step_ms(torch, te, ts, cfg, model_cfg, ds, True)
           if has_graph else None}
    print(f"step: eager {res['step_eager_ms']:.4f} ms, graph replay "
          f"{res['step_graph_ms']} ms (CUDA events, mean over 5 passes)",
          flush=True)
    main_path = True if has_graph else None
    res["step_nodiag_ms"] = step_ms(torch, te, ts, cfg, model_cfg, ds,
                                    main_path, diag=False)
    res["step_mnist_pass_ms"] = step_ms(torch, te, ts, cfg, model_cfg, ds,
                                        main_path, steps=600, passes=2)
    print(f"step, {'graph replay' if has_graph else 'eager'}: diagnostics "
          f"off {res['step_nodiag_ms']:.4f} ms; diagnostics on over a "
          f"600-step pass (50 in the SNR window) "
          f"{res['step_mnist_pass_ms']:.4f} ms (CUDA events)", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        over = {"n_stages": 4}
        if hasattr(cfg, "log_dir"):
            over.update(log_dir=tmp + "/runs", checkpoint_dir=tmp + "/ckpt")
        _, hist = run_experiment(dataclasses.replace(cfg, **over))
    prev, stages = 0, {}
    for h in hist:
        stages[h["stage"]] = h["stage_train_seconds"] * 1e3 / (h["steps"]
                                                               - prev)
        prev = h["steps"]
        print(f"driver: stage {h['stage']} ({h['passes']} passes) host ms "
              f"per step {stages[h['stage']]:.4f}", flush=True)
    res["stage_host_ms_per_step"] = stages
    res["block_host_ms_per_step"] = block_ms(torch, te, ts, cfg, model_cfg,
                                             ds, 27)
    res["paper_run_hours"] = res["block_host_ms_per_step"] * PAPER_STEPS \
        / 3.6e6
    print(f"block: one dispatch of 27 passes host ms per step "
          f"{res['block_host_ms_per_step']:.4f}; the paper's "
          f"{PAPER_STEPS} steps at that rate: "
          f"{res['paper_run_hours']:.3f} h", flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

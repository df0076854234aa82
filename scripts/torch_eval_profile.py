#!/usr/bin/env python3
"""Where the PyTorch port's evaluation time goes on the card, by
torch.profiler.

    python3 scripts/torch_eval_profile.py [--out PATH.json]

Builds the ``northstar-iwae-2l-k50`` model of the port on ``cuda`` (fresh
weights from the preset's seed; bf16 operands, the fused hot loop), takes
1000 synthetic test rows from the data loaders, warms up, then profiles two
windows with ``torch.profiler`` (CPU and CUDA activities):

* ``nll_batch``: one k=5000 NLL batch of 500 rows (20 chunks of k=250, the
  ``streaming_nll`` that ``training_statistics`` runs per eval batch);
* ``suite``: the whole ``training_statistics`` suite on the 1000 rows
  (eval_k=50, nll_k=5000, chunk 250, batches of 500, 1000 activity
  samples), ending in its one fetch.

For each window it reports the kernels launched per iteration (a chunk, or
the suite), device time by kernel name, the device's busy time (the union
of kernel intervals) and its busy share of the window, beside the window's
host-clock time. Prints one JSON object, and also writes it to ``--out``
when given. Needs a CUDA device; it imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_serving_profile import _trace_stats  # noqa: E402

PRESET = "northstar-iwae-2l-k50"
ROWS = 1000


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the JSON object to this file")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("no CUDA device: this profile runs on the GPU", file=sys.stderr)
        return 1
    from iwae_replication_project_tpu_torch import zoo
    from iwae_replication_project_tpu_torch.data import load_dataset
    from iwae_replication_project_tpu_torch.evaluation import metrics as em
    from iwae_replication_project_tpu_torch.models.iwae import (
        init_params, to_device)

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    cfg = zoo.get(PRESET)
    model_cfg = cfg.model_config("cuda")
    params = to_device(init_params(torch.Generator().manual_seed(cfg.seed),
                                   model_cfg), torch.device("cuda"))
    ds = load_dataset(cfg.dataset, data_dir=cfg.data_dir,
                      synthetic_sizes=(1024, ROWS))
    x = torch.as_tensor(ds.x_test[:ROWS].reshape(ROWS, -1),
                        dtype=torch.float32).cuda()
    xb = x[:cfg.eval_batch_size]
    gen = torch.Generator(device="cuda").manual_seed(0)

    def nll_batch():
        return em.streaming_nll(params, model_cfg, xb, cfg.nll_k,
                                cfg.nll_chunk, generator=gen)

    def suite():
        return em.training_statistics(
            params, model_cfg, x, cfg.eval_k, batch_size=cfg.eval_batch_size,
            nll_k=cfg.nll_k, nll_chunk=cfg.nll_chunk,
            activity_samples=cfg.activity_samples, generator=gen)

    nll_batch()
    suite()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {"card": smi, "preset": PRESET, "rows": ROWS}
    for name, fn, iterations in (("nll_batch", nll_batch,
                                  cfg.nll_k // cfg.nll_chunk),
                                 ("suite", suite, 1)):
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        stats = _trace_stats(prof, iterations)
        stats["wall_ms_host"] = wall * 1e3
        out[name] = stats
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())

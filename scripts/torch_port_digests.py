#!/usr/bin/env python3
"""Digests of what the port computes on the card, to hold two checkouts
bitwise against each other.

    python3 scripts/torch_port_digests.py [--port-root DIR]

At the flagship (``northstar-iwae-2l-k50``, fresh weights from the preset's
seed, no autotune cache, no precision policy) it computes, on ``cuda``:

* ``serve``: score, encode and decode rows served by the pipelined engine
  in ragged batches (every bucket 1..64), fixed request seeds;
* ``train``: the parameters after one pass of three train steps (the
  driver's epoch function, a replayed CUDA graph) on seeded rows;
* ``nll``: one k=5000 NLL batch of 500 seeded rows in chunks of 250
  (``evaluation.metrics.streaming_log_px``, the eval generator).

Prints one JSON object with a SHA-256 of each result's bytes and the card's
name and power limit. ``--port-root`` imports the port from another
checkout (a parent tree unpacked with ``git archive``): equal digests mean
the two trees give the same bits. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
PRESET = "northstar-iwae-2l-k50"


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port-root", default=str(HERE))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.port_root).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the digests are the card's", file=sys.stderr)
        return 1
    from iwae_replication_project_tpu_torch import zoo
    from iwae_replication_project_tpu_torch.evaluation import metrics as em
    from iwae_replication_project_tpu_torch.training import epoch as te
    from iwae_replication_project_tpu_torch.training import train_step as ts
    from iwae_replication_project_tpu_torch.utils.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(21)
    out = {"port_root": args.port_root}

    eng = zoo.serving_engine(PRESET, seed=0, timeout_s=None)
    eng.start()
    served = []
    for op, d in (("score", 784), ("encode", 784),
                  ("decode", eng.row_dims["decode"])):
        futures, seed = [], 0
        for n in range(1, 65, 7):
            rows = (rng.rand(n, d) > 0.5).astype(np.float32) \
                if op != "decode" else rng.randn(n, d).astype(np.float32)
            futures += [eng.submit(op, r, seed=seed + i)
                        for i, r in enumerate(rows)]
            seed += n
        served += [np.asarray(f.result(timeout=300)) for f in futures]
    eng.stop()
    out["serve"] = _digest(served)

    cfg = zoo.get(PRESET)
    model_cfg = cfg.model_config("cuda")
    x = torch.from_numpy((rng.rand(300, 784) > 0.5).astype(np.float32))
    fn = te.make_epoch_fn(cfg.objective_spec(1), model_cfg, 300, 100)
    state, losses = fn(ts.create_train_state(0, model_cfg), x.cuda())
    out["train"] = _digest([t.detach().cpu().numpy()
                            for t in tree_leaves(state.params)]
                           + [losses.cpu().numpy()])

    xb = torch.from_numpy((rng.rand(500, 784) > 0.5).astype(np.float32))
    with torch.no_grad():
        nll = em.streaming_log_px(state.params, model_cfg, xb.cuda(), 5000,
                                  250, generator=em.eval_generator(0, 1,
                                                                   "cuda"))
    out["nll"] = _digest([nll.cpu().numpy()])
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

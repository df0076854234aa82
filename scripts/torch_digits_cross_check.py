#!/usr/bin/env python3
"""The whole-run cross-check of the port against the JAX package on the
real ``digits`` data: the staged driver's NLL curves of both packages.

    python3 scripts/torch_digits_cross_check.py --jax    # the JAX half (CPU)
    python3 scripts/torch_digits_cross_check.py --port   # the port's half (card)
    python3 scripts/torch_digits_cross_check.py --merge  # both, gaps, verdict

Configurations, each over seeds 0-2 and 5 Burda stages on ``digits``
(``allow_synthetic=False``, no stage figures, no diagnostics):

* ``a_iwae`` / ``a_dreg``: the JAX package's own cross-check config
  (``scripts/run_replication.py:179-185``): the 1-layer architecture, k=5,
  fp32, ``eval_batch_size=99``, ``nll_k=500``, trained with IWAE and DReG;
* ``b_flagship``: ``northstar-iwae-2l-k50`` at full width (784 -> (200,
  200) -> 100 -> (100, 100) -> 50, k=50, logits, bf16 operands with fp32
  accumulation), IWAE, ``nll_k=5000`` in chunks of 250.

The two packages never share draws (threefry against torch's generators)
nor initial weights, so only statistical agreement is expected. The JAX
half therefore sets the bound, before any port number exists: for each
stage, ``max(BOUND_FLOOR, BOUND_SE_FACTOR x the standard error of JAX's
mean NLL over the seeds)``, i.e. 3 standard errors of the difference of
two means with JAX's seed-to-seed spread (at least 2 nats). ``--merge``
holds each stage's |mean port NLL - mean JAX NLL| against it and reports
a miss as a miss.

``--jax`` imports JAX inside its own function and runs on the CPU;
``--port`` imports nothing of JAX and runs on the card unless ``--device
cpu``, and records the card's name and power limit (``nvidia-smi``) beside
its wall seconds. ``--tiny`` runs narrow widths, 2 stages, seeds 0-1 and a
few batches per pass: the script's own test, seconds on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
RESULTS = HERE / "results"
JAX_HALF = RESULTS / "torch_port_cross_check_jax.json"
PORT_HALF = HERE / "runs" / "torch_port_cross_check_port.json"
MERGED = RESULTS / "torch_port_cross_check.json"

SEEDS = (0, 1, 2)
N_STAGES = 5
#: the bound: 3 standard errors of a difference of two means whose spread is
#: JAX's, 3 * sqrt(2) * se(JAX mean), and never under 2 nats
BOUND_SE_FACTOR = 3.0 * math.sqrt(2.0)
BOUND_FLOOR = 2.0

_ARCH_1L = dict(n_hidden_encoder=(200,), n_hidden_decoder=(200,),
                n_latent_encoder=(50,), n_latent_decoder=(784,))
_ARCH_2L = dict(n_hidden_encoder=(200, 100), n_hidden_decoder=(100, 200),
                n_latent_encoder=(100, 50), n_latent_decoder=(100, 784))
_BASE = dict(dataset="digits", allow_synthetic=False, n_stages=N_STAGES,
             save_figures=False, resume=False, diagnostics=False,
             likelihood="logits")

#: name -> the config fields both packages' ExperimentConfig take
CONFIGS = {
    "a_iwae": dict(_BASE, **_ARCH_1L, loss_function="IWAE", k=5,
                   compute_dtype="float32", eval_batch_size=99, nll_k=500),
    "a_dreg": dict(_BASE, **_ARCH_1L, loss_function="DReG", k=5,
                   compute_dtype="float32", eval_batch_size=99, nll_k=500),
    "b_flagship": dict(_BASE, **_ARCH_2L, loss_function="IWAE", k=50,
                       compute_dtype="bfloat16", nll_k=5000, nll_chunk=250),
}

#: --tiny: the same three configurations at test size
_TINY = dict(n_hidden_encoder=(16,), n_hidden_decoder=(16,),
             n_latent_encoder=(4,), n_latent_decoder=(784,), n_stages=2,
             eval_k=4, nll_k=8, nll_chunk=4, activity_samples=8)
TINY_SEEDS = (0, 1)
TINY_BATCHES = 2  # batches per pass


def _configs(tiny: bool) -> dict:
    if not tiny:
        return CONFIGS
    return {name: dict(c, **_TINY, k=min(c["k"], 4)) for name, c in
            CONFIGS.items()}


def _curve(history_rows, wall: float) -> dict:
    return {"NLL_by_stage": [float(r["NLL"]) for r in history_rows],
            "IWAE_by_stage": [float(r["IWAE"]) for r in history_rows],
            "wall_seconds": wall}


def _stats(curves) -> dict:
    """Per stage: the mean over seeds, its standard error (None for one
    seed) and the bound it sets."""
    import numpy as np

    nll = np.array([c["NLL_by_stage"] for c in curves])
    mean = nll.mean(axis=0)
    n = nll.shape[0]
    se = nll.std(axis=0, ddof=1) / math.sqrt(n) if n > 1 else None
    bound = [max(BOUND_FLOOR, BOUND_SE_FACTOR * s) for s in se] \
        if se is not None else [BOUND_FLOOR] * nll.shape[1]
    return {"mean_NLL": mean.tolist(),
            "se_NLL": None if se is None else se.tolist(),
            "bound": bound}


def _run_all(doc: dict, train, seeds, tiny: bool, path: Path) -> dict:
    """Every configuration and seed through ``train(fields, seed) ->
    (history rows, extra)``, the document rewritten at `path` after each
    run so a long half keeps what it finished."""
    doc["seeds"] = list(seeds)
    doc["configs"] = {}
    for name, fields in _configs(tiny).items():
        curves = []
        for seed in seeds:
            t0 = time.perf_counter()
            rows, extra = train(fields, seed)
            curves.append(dict(_curve(rows, time.perf_counter() - t0),
                               **extra))
            print(f"{doc['package']} {name} seed {seed}: NLL "
                  f"{curves[-1]['NLL_by_stage']} in "
                  f"{curves[-1]['wall_seconds']:.1f} s {extra}", flush=True)
            doc["configs"][name] = {"fields": _jsonable(fields),
                                    "curves": curves, **_stats(curves)}
            _write(path, doc)
    return doc


def run_jax(seeds, tiny: bool, path: Path) -> dict:
    """The JAX half: every configuration and seed through the JAX driver on
    this host's CPU."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from iwae_replication_project_tpu.experiment import run_experiment
    from iwae_replication_project_tpu.utils.config import ExperimentConfig

    doc = {"package": "iwae_replication_project_tpu", "device": "cpu",
           "host_cpus": os.cpu_count(), "jax": jax.__version__}
    with tempfile.TemporaryDirectory() as d:
        def train(fields, seed):
            cfg = ExperimentConfig(**fields, seed=seed, log_dir=f"{d}/runs",
                                   checkpoint_dir=f"{d}/ckpt")
            hist = run_experiment(cfg, max_batches_per_pass=TINY_BATCHES
                                  if tiny else None)[1]
            return [r for r, _ in hist], {}
        return _run_all(doc, train, seeds, tiny, path)


def run_port(seeds, tiny: bool, device, path: Path) -> dict:
    """The port's half: every configuration and seed through the port's
    driver, on the card unless `device` is ``"cpu"``, with B1/B2's launches
    of each run."""
    from iwae_replication_project_tpu_torch.experiment import run_experiment
    from iwae_replication_project_tpu_torch.ops import _kernels
    from iwae_replication_project_tpu_torch.utils.config import (
        ExperimentConfig)

    doc = {"package": "iwae_replication_project_tpu_torch",
           "device": device or "cuda"}
    if device != "cpu":
        doc["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    with tempfile.TemporaryDirectory() as d:
        def train(fields, seed):
            cfg = ExperimentConfig(**fields, seed=seed, log_dir=f"{d}/runs",
                                   checkpoint_dir=f"{d}/ckpt")
            _kernels.reset_launch_counts(_kernels.COUNTERS)
            hist = run_experiment(cfg, device=device,
                                  max_batches_per_pass=TINY_BATCHES
                                  if tiny else None)[1]
            return hist, {"launches": _kernels.launch_counts(
                ("hot_loop_fwd", "hot_loop_bwd"))}
        return _run_all(doc, train, seeds, tiny, path)


def merge(jax_half: dict, port_half: dict) -> dict:
    """Both halves, each stage's gap of the means and whether it is inside
    the bound the JAX half set."""
    out = {"bound_rule": f"per stage max({BOUND_FLOOR}, "
                         f"3*sqrt(2)*se of the JAX mean NLL over the seeds), "
                         f"set by the JAX half before the port ran",
           "jax": jax_half, "port": port_half, "gaps": {}}
    ok = True
    for name, j in jax_half["configs"].items():
        p = port_half["configs"][name]
        gap = [pm - jm for pm, jm in zip(p["mean_NLL"], j["mean_NLL"])]
        inside = [abs(g) <= b for g, b in zip(gap, j["bound"])]
        ok = ok and all(inside)
        out["gaps"][name] = {"gap_NLL": gap, "bound": j["bound"],
                             "inside": inside}
    out["all_inside"] = ok
    return out


def _jsonable(fields: dict) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in fields.items()}


def _write(path: Path, doc: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=1) + "\n")
    print(f"wrote {path}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--jax", action="store_true")
    mode.add_argument("--port", action="store_true")
    mode.add_argument("--merge", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    ap.add_argument("--jax-half", default=str(JAX_HALF))
    ap.add_argument("--port-half", default=str(PORT_HALF))
    ap.add_argument("--out", default=None,
                    help="where --merge writes (default "
                         "results/torch_port_cross_check.json)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    seeds = TINY_SEEDS if args.tiny else SEEDS
    if args.jax:
        run_jax(seeds, args.tiny, Path(args.jax_half))
    elif args.port:
        run_port(seeds, args.tiny, args.device, Path(args.port_half))
    else:
        doc = merge(json.loads(Path(args.jax_half).read_text()),
                    json.loads(Path(args.port_half).read_text()))
        _write(Path(args.out or MERGED), doc)
        for name, g in doc["gaps"].items():
            print(f"{name}: gap {[round(v, 3) for v in g['gap_NLL']]} "
                  f"bound {[round(v, 3) for v in g['bound']]} inside "
                  f"{g['inside']}")
        print(f"all inside: {doc['all_inside']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

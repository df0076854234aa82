#!/usr/bin/env python3
"""The STL and PIWAE training runs of ``scripts/estimator_convergence.py``
on the port: both estimators trained on the real ``digits`` data through
the port's staged driver under the scaled Burda schedule (8 stages,
``passes_scale=0.2``; the 1-layer h64 z16 architecture, k=50, PIWAE's
k1 x k2 = 10 x 5), on the card unless ``--device cpu``.

    python3 scripts/torch_estimator_convergence.py [--short] [--tiny]

Writes ``results/torch_convergence_stl.json`` and
``torch_convergence_piwae.json``, the JAX files' fields
(``results/convergence_{stl,piwae}.json``) plus the card's name and power
limit, B1/B2's launches and the run's wall seconds. JAX ran one seed, so
``scripts/torch_run_replication.py --check`` reports the port's curves
beside JAX's without a gate. ``--short`` is the 3-stage proxy; ``--tiny``
test widths, 2 stages and 2 batches a pass, under ``--results-dir``.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

RESULTS = HERE / "results"

#: the two runs: name -> (ExperimentConfig overrides, output file)
RUNS = {
    "STL": (dict(loss_function="STL", k=50), "torch_convergence_stl.json"),
    "PIWAE": (dict(loss_function="PIWAE", k=50, k2=5),
              "torch_convergence_piwae.json"),
}
TINY = dict(n_hidden_encoder=(16,), n_hidden_decoder=(16,),
            n_latent_encoder=(4,), n_stages=2, k=4, eval_k=4, nll_k=8,
            nll_chunk=4, activity_samples=8)
TINY_BATCHES = 2


def run_config(workdir: str, short: bool, tiny: bool = False, **over):
    """JAX's configuration (``scripts/estimator_convergence.py:45-63``)."""
    from iwae_replication_project_tpu_torch.utils.config import (
        ExperimentConfig)

    d = dict(
        dataset="digits", allow_synthetic=False,
        n_hidden_encoder=(64,), n_hidden_decoder=(64,),
        n_latent_encoder=(16,), n_latent_decoder=(784,),
        batch_size=100, eval_k=5, nll_k=128, nll_chunk=64,
        eval_batch_size=99, activity_samples=64, save_figures=False,
        resume=False, seed=0,
        log_dir=f"{workdir}/runs", checkpoint_dir=f"{workdir}/ckpt",
    )
    d.update(dict(n_stages=3) if short
             else dict(n_stages=8, passes_scale=0.2))
    d.update(over)
    if tiny:
        d.update(TINY, k2=min(d.get("k2", 1), 2))
    return ExperimentConfig(**d)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--short", action="store_true",
                    help="3-stage proxy instead of the full scaled schedule")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    ap.add_argument("--results-dir", default=str(RESULTS))
    args = ap.parse_args(argv)

    from iwae_replication_project_tpu_torch.experiment import run_experiment
    from iwae_replication_project_tpu_torch.ops import _kernels

    card = None
    if args.device != "cpu":
        sys.path.insert(0, str(HERE / "scripts"))
        from torch_run_replication import card_name
        card = card_name()
    out_dir = Path(args.results_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, (over, fname) in RUNS.items():
        with tempfile.TemporaryDirectory() as workdir:
            cfg = run_config(workdir, args.short, args.tiny, **over)
            print(f"=== {name}: {cfg.n_stages} stages, k={cfg.k}"
                  + (f" k2={cfg.k2}" if name == "PIWAE" else ""), flush=True)
            _kernels.reset_launch_counts(_kernels.COUNTERS)
            t0 = time.perf_counter()
            _, history = run_experiment(
                cfg, device=args.device,
                max_batches_per_pass=TINY_BATCHES if args.tiny else None)
            wall = time.perf_counter() - t0
            launches = _kernels.launch_counts(("hot_loop_fwd",
                                               "hot_loop_bwd"))
        stages = [{"stage": r["stage"], "NLL": r["NLL"], "IWAE": r["IWAE"],
                   "VAE": r["VAE"],
                   "active_units": r["number_of_active_units"],
                   "stage_train_seconds": r["stage_train_seconds"]}
                  for r in history]
        nlls = [s["NLL"] for s in stages]
        out = {
            "estimator": name,
            "protocol": ("digits 3-stage CI proxy" if args.short else
                         "digits scaled Burda schedule (8 stages, "
                         "passes_scale=0.2), RESULTS.md §2 protocol"),
            "config": {"k": cfg.k, "k2": cfg.k2, "seed": cfg.seed,
                       "n_stages": cfg.n_stages,
                       "passes_scale": cfg.passes_scale,
                       "arch": "1L h64 z16", "dataset": "digits",
                       "synthetic_data": bool(history[0]["synthetic_data"]),
                       "run_name": cfg.run_name(), "tiny": args.tiny},
            "stages": stages,
            "final_NLL": nlls[-1],
            "best_NLL": min(nlls),
            "steps": int(history[-1]["steps"]),
            "launches": launches,
            "wall_seconds": wall,
            "device": args.device or "cuda",
            "card": card,
        }
        path = out_dir / fname
        path.write_text(json.dumps(out, indent=1) + "\n")
        print(f"{name}: final NLL {nlls[-1]:.2f}, best {min(nlls):.2f}, "
              f"{wall:.1f} s, launches {launches} -> {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

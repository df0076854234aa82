#!/usr/bin/env python3
"""The production protocol at production scale on the port
(``scripts/dress_rehearsal.py``'s counterpart), on the card unless
``--device cpu``.

    python3 scripts/torch_dress_rehearsal.py [--dataset D] [--fresh] [--check]

Runs the ``northstar-iwae-2l-k50`` preset (2L, IWAE k=50, logits, bf16
operands with fp32 accumulation) through the port's staged driver
(``experiment.run_experiment``): all 8 Burda stages, 3,280 passes, the full
evaluation suite on the whole test set after each stage (the k=5000
streamed NLL, activity, the pruned NLL) and a checkpoint inside a stage
every ``--checkpoint-every-passes`` passes (200).

The data is synthetic but written at the real sizes in the reference's
on-disk formats (:func:`make_fixture_files`, the JAX script's files under
the same names from the same code and seed), and read back through the
port's loaders with the synthetic fallback off:

* ``binarized_mnist``: ``binarized_mnist_{train,test}.amat`` (the
  Larochelle text format, ~78 MB / ~16 MB, fixed binarization) with the
  raw ``train``/``t10k`` idx pair beside them, so the decoder bias takes the
  raw means (the reference's policy);
* ``omniglot``: the Burda split's ``chardata.mat``, 24,345 / 8,070 rows
  of grayscale, binarized on the device every pass; the test set clamps
  the eval batch to 269 (the largest divisor of 8,070 up to 500);
* ``fashion_mnist``: the 60k/10k idx pair under ``fashion_mnist/``, also
  binarized every pass.

Prints a per-stage table (train and eval seconds, steps/s, host ms per
step, NLL, JAX's NLL at that stage and the gap) and one JSON summary line:
JAX's fields, plus the driver's data-load seconds, the eval batch used,
the raw-means bias flag, B1's and B2's launches beside the count derived
from the steps and evaluations, the compile fields of ``utils/
compile_cache``, the card's name and power limit (``nvidia-smi``) and the
gap of the final NLL to JAX's committed run of the same dataset
(``results/dress_rehearsal[_<dataset>].json``). ``--check`` exits 1 when a
complete, fresh, unscaled run ends more than :data:`BOUND` nats from it.

Only a complete, fresh run writes its summary:
``results/torch_dress_rehearsal[_<dataset>].json``, or ``..._scaled.json``
with ``--passes-scale`` other than 1. A resumed or partial run prints its
table and writes nothing. Fixture files go to ``data/rehearsal/``, logs to
``runs/torch_dress_rehearsal/``, checkpoints and the kernels' libraries to
``checkpoints/torch_dress_rehearsal/`` (all gitignored).
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import os
import struct
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(REPO, "data", "rehearsal")

#: real dataset sizes (train, test): MNIST per the Larochelle split, Omniglot
#: per the Burda chardata.mat split, Fashion-MNIST per its idx files
SIZES = {"binarized_mnist": (50_000, 10_000),
         "omniglot": (24_345, 8_070),
         "fashion_mnist": (60_000, 10_000)}

PRESET = "northstar-iwae-2l-k50"

#: the final NLL's largest distance from JAX's committed run: max(2, 3 *
#: sqrt(2) * se) with one JAX seed, so no se
BOUND = 2.0


def out_json(dataset: str, root: str = REPO, scaled: bool = False) -> str:
    suffix = ("" if dataset == "binarized_mnist" else f"_{dataset}") + \
        ("_scaled" if scaled else "")
    return os.path.join(root, "results", f"torch_dress_rehearsal{suffix}.json")


def jax_json(dataset: str) -> str:
    suffix = "" if dataset == "binarized_mnist" else f"_{dataset}"
    return os.path.join(REPO, "results", f"dress_rehearsal{suffix}.json")


def write_idx_gz(path, images_uint8: np.ndarray) -> None:
    """Write MNIST idx3-ubyte .gz, the raw-MNIST format the reference's data
    pipeline downloads. `images_uint8` is [N, 28, 28] or [N, 784] uint8."""
    arr = np.ascontiguousarray(images_uint8, dtype=np.uint8)
    n = len(arr)
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + arr.tobytes())


def make_fixture_files(dataset: str, data_dir: str = DATA_DIR,
                       sizes=None) -> float:
    """Write the reference-format files for `dataset` at `sizes` ((train,
    test) rows; default the real :data:`SIZES`), idempotent; returns the
    generation seconds (0.0 when already present)."""
    from iwae_replication_project_tpu_torch.data.loaders import _synthetic

    n_train, n_test = sizes or SIZES[dataset]
    t0 = time.perf_counter()
    if dataset == "binarized_mnist":
        train_p = os.path.join(data_dir, "binarized_mnist_train.amat")
        test_p = os.path.join(data_dir, "binarized_mnist_test.amat")
        raw_tr_p = os.path.join(data_dir, "train-images-idx3-ubyte.gz")
        raw_te_p = os.path.join(data_dir, "t10k-images-idx3-ubyte.gz")
        if all(os.path.exists(p) for p in (train_p, test_p, raw_tr_p,
                                           raw_te_p)):
            return 0.0
        os.makedirs(data_dir, exist_ok=True)
        x_train, x_test = _synthetic(dataset, n_train, n_test, seed=0)
        # Larochelle .amat: one "%d %d ... %d" line per image
        np.savetxt(train_p, x_train, fmt="%d")
        np.savetxt(test_p, x_test, fmt="%d")
        # raw grayscale (the probabilities scaled to [0,255]) for the
        # raw-means bias policy: the loader requires the train/t10k pair
        gray_tr, gray_te = _synthetic(dataset, n_train, n_test, seed=0,
                                      binary=False)
        write_idx_gz(raw_tr_p,
                     (gray_tr * 255).astype(np.uint8).reshape(-1, 28, 28))
        write_idx_gz(raw_te_p,
                     (gray_te * 255).astype(np.uint8).reshape(-1, 28, 28))
    elif dataset == "omniglot":
        # the Burda-split chardata.mat: "data"/"testdata" as [784, N]
        # grayscale in [0,1]; the protocol re-binarizes per pass on device
        p = os.path.join(data_dir, "chardata.mat")
        if os.path.exists(p):
            return 0.0
        os.makedirs(data_dir, exist_ok=True)
        import scipy.io as sio
        gray_tr, gray_te = _synthetic(dataset, n_train, n_test, seed=0,
                                      binary=False)
        sio.savemat(p, {"data": gray_tr.T.astype(np.float32),
                        "testdata": gray_te.T.astype(np.float32)})
    elif dataset == "fashion_mnist":
        sub = os.path.join(data_dir, "fashion_mnist")
        tr = os.path.join(sub, "train-images-idx3-ubyte.gz")
        te = os.path.join(sub, "t10k-images-idx3-ubyte.gz")
        if os.path.exists(tr) and os.path.exists(te):
            return 0.0
        os.makedirs(sub, exist_ok=True)
        gray_tr, gray_te = _synthetic(dataset, n_train, n_test, seed=0,
                                      binary=False)
        write_idx_gz(tr, (gray_tr * 255).astype(np.uint8).reshape(-1, 28, 28))
        write_idx_gz(te, (gray_te * 255).astype(np.uint8).reshape(-1, 28, 28))
    else:
        raise ValueError(f"no rehearsal fixtures for dataset {dataset!r}")
    return time.perf_counter() - t0


def rehearsal_config(dataset: str, data_dir: str = DATA_DIR,
                     checkpoint_every_passes: int = 200, fresh: bool = False,
                     passes_scale: float = 1.0, root: str = REPO,
                     overrides=None):
    """The preset as the rehearsal runs it: the files must be found, no
    figures, logs and checkpoints under `root`, the kernels' libraries under
    the checkpoint root. `overrides` sets further fields (tests)."""
    from iwae_replication_project_tpu_torch import zoo

    cfg = zoo.get(PRESET)  # the 2L flagship, IWAE k=50
    cfg.dataset = dataset
    cfg.data_dir = data_dir
    cfg.allow_synthetic = False  # the files MUST be found: that is the test
    cfg.log_dir = os.path.join(root, "runs", "torch_dress_rehearsal")
    cfg.checkpoint_dir = os.path.join(root, "checkpoints",
                                      "torch_dress_rehearsal")
    cfg.compile_cache_dir = os.path.join(cfg.checkpoint_dir, "compile_cache")
    cfg.checkpoint_every_passes = checkpoint_every_passes
    cfg.save_figures = False
    cfg.resume = not fresh
    cfg.passes_scale = passes_scale
    for name, value in (overrides or {}).items():
        setattr(cfg, name, value)
    return cfg


def eval_b1_launches(cfg, n_test: int) -> int:
    """B1 launches of one stage's evaluation on `n_test` rows: per eval
    batch one for the batch metrics and nll_k/chunk for the streamed NLL,
    nll_k/chunk for the pruned NLL, and with diagnostics one per batch."""
    from iwae_replication_project_tpu_torch.utils.sizes import (
        largest_divisor_leq)

    batch = largest_divisor_leq(n_test, min(cfg.eval_batch_size, n_test))
    chunks = cfg.nll_k // largest_divisor_leq(cfg.nll_k, cfg.nll_chunk)
    n_batches = n_test // batch
    return n_batches * (1 + chunks) + chunks + \
        (n_batches if cfg.diagnostics else 0)


def card_name():
    """``nvidia-smi``'s name and power limit of the card, None without
    one."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


@contextlib.contextmanager
def timed_loads(seconds: list):
    """Time the driver's own dataset loads (``experiment.load_dataset``),
    appending each one's seconds to `seconds`."""
    from iwae_replication_project_tpu_torch import experiment

    load = experiment.load_dataset

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return load(*args, **kwargs)
        finally:
            seconds.append(time.perf_counter() - t0)

    experiment.load_dataset = timed
    try:
        yield
    finally:
        experiment.load_dataset = load


def run(dataset: str, *, data_dir: str = DATA_DIR,
        checkpoint_every_passes: int = 200, fresh: bool = False,
        passes_scale: float = 1.0, device=None, root: str = REPO,
        sizes=None, overrides=None) -> tuple:
    """Write the fixtures, run the rehearsal and print its table; returns
    ``(summary, path written or None)``. `sizes` and `overrides` cut the
    data and the config (tests); a run with either, or with `passes_scale`
    other than 1, is not the protocol and writes ``..._scaled.json``."""
    from iwae_replication_project_tpu_torch.experiment import run_experiment
    from iwae_replication_project_tpu_torch.ops import _kernels, hot_loop
    from iwae_replication_project_tpu_torch.training import burda_stages
    from iwae_replication_project_tpu_torch.utils.checkpoint import (
        latest_step)
    from iwae_replication_project_tpu_torch.utils.compile_cache import (
        cache_stats, stats_delta)
    from iwae_replication_project_tpu_torch.utils.device import (
        resolve_device)

    resolve_device(device)  # a missing card fails before the fixtures
    gen_s = make_fixture_files(dataset, data_dir, sizes)
    print(f"fixture files: {data_dir} (generation {gen_s:.1f}s)", flush=True)
    cfg = rehearsal_config(dataset, data_dir, checkpoint_every_passes, fresh,
                           passes_scale, root, overrides)
    protocol = passes_scale == 1.0 and not sizes and not overrides

    # a checkpoint already there means this process resumes (its first
    # stage's timings cover only the remaining passes): still run, but mark
    # the measurement partial and write nothing
    resumed = cfg.resume and latest_step(
        os.path.join(cfg.checkpoint_dir, cfg.run_name())) is not None

    kernels = (hot_loop.KERNEL, hot_loop.KERNEL_BWD)
    load_s = []
    stats0 = cache_stats()
    _kernels.reset_launch_counts(kernels)
    with timed_loads(load_s):
        t0 = time.perf_counter()
        history = run_experiment(cfg, device=device)[1]
        total_s = time.perf_counter() - t0
    launches = _kernels.launch_counts(kernels)
    cache_delta = stats_delta(stats0)

    n_train, n_test = sizes or SIZES[dataset]
    per_pass = n_train // cfg.batch_size
    lengths = {s: n for s, _, n in burda_stages(cfg.n_stages,
                                                cfg.passes_scale)}
    jax_rows = {}
    if os.path.exists(jax_json(dataset)):
        with open(jax_json(dataset)) as f:
            jax_rows = {r["stage"]: r["NLL"] for r in json.load(f)["stages"]}
    rows = []
    print(f"\n{'stage':>5} {'passes':>6} {'train s':>9} {'eval s':>8} "
          f"{'steps/s':>9} {'ms/step':>8} {'NLL':>9} {'JAX NLL':>9} "
          f"{'gap':>7}")
    for res in history:
        st = int(res["stage"])
        timed = int(res["stage_passes_timed"])
        steps = timed * per_pass
        tr, ev = res["stage_train_seconds"], res["stage_eval_seconds"]
        jax_nll = jax_rows.get(st)
        rows.append({
            "stage": st, "passes": lengths[st], "passes_timed": timed,
            "train_seconds": round(tr, 3), "eval_seconds": round(ev, 3),
            "checkpoint_seconds": round(res["stage_checkpoint_seconds"], 3),
            "steps_per_sec": round(steps / tr, 1) if tr else None,
            "ms_per_step": round(tr / steps * 1e3, 4) if steps else None,
            "NLL": round(res["NLL"], 3),
            "captures": int(res["aot_misses"]),
            "capture_seconds": round(res["aot_compile_seconds"], 3),
            "replays": int(res["aot_hits"]),
            "libraries_found_built": int(res["compile_cache_hits"]),
            "nvcc_builds": int(res["compile_cache_misses"]),
            "nvcc_seconds": round(res["compile_seconds"], 3)})
        gap = "" if jax_nll is None else f"{res['NLL'] - jax_nll:+7.3f}"
        print(f"{st:>5} {lengths[st]:>6} {tr:>9.1f} {ev:>8.1f} "
              f"{rows[-1]['steps_per_sec'] or 0:>9.1f} "
              f"{rows[-1]['ms_per_step'] or 0:>8.4f} {res['NLL']:>9.3f} "
              f"{'' if jax_nll is None else f'{jax_nll:9.3f}':>9} {gap}",
              flush=True)

    steps_run = sum(r["passes_timed"] for r in rows) * per_pass
    per_eval = eval_b1_launches(cfg, n_test)
    last = history[-1] if history else {}
    jax_final = jax_rows.get(cfg.n_stages)
    final = rows[-1]["NLL"] if rows and \
        rows[-1]["stage"] == cfg.n_stages else None
    gap = None if final is None or jax_final is None else \
        round(final - jax_final, 3)
    complete = not resumed and len(rows) == cfg.n_stages
    held = protocol and complete
    summary = {
        "metric": f"2L IWAE k=50 dress rehearsal on {dataset} through the "
                  f"PyTorch/CUDA port (synthetic data at real file sizes)",
        "n_train": n_train, "n_test": n_test,
        "binarization": "fixed" if dataset == "binarized_mnist"
        else "stochastic (per-pass, on device)",
        "total_seconds": round(total_s, 1),
        "fixture_generation_seconds": round(gen_s, 1),
        "data_load_seconds": round(sum(load_s), 3),
        "checkpoint_every_passes": checkpoint_every_passes,
        "passes_scale": passes_scale,
        "eval_batch_used": int(last["eval_batch"]) if history else None,
        "raw_means_bias": bool(last.get("raw_means_bias")),
        "synthetic_data": bool(last.get("synthetic_data")),
        "steps": steps_run,
        "launches": launches,
        # the kernels launch on the card only; on the CPU the count is 0
        "launches_expected": {
            hot_loop.KERNEL: steps_run + len(rows) * per_eval,
            hot_loop.KERNEL_BWD: steps_run},
        "compile_cache": {
            k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in cache_delta.items()},
        "card": card_name(),
        "device": str(device or "cuda"),
        "resumed": resumed,
        "jax_final_NLL": jax_final,
        "jax_NLL_by_stage": [jax_rows.get(r["stage"]) for r in rows],
        "gap": gap,
        "bound": BOUND,
        "held": held,
        "within_bound": None if gap is None else abs(gap) <= BOUND,
        "stages": rows,
    }
    print(json.dumps(summary), flush=True)
    if gap is not None:
        print(f"final NLL {final:.3f} against JAX's {jax_final:.3f}: gap "
              f"{gap:+.3f}, bound {BOUND} "
              f"({'held' if held else 'printed, not held'})", flush=True)
    dest = out_json(dataset, root, scaled=not protocol)
    if not complete:
        print(f"partial/resumed run ({len(rows)}/{cfg.n_stages} stages "
              f"measured{', resumed' if resumed else ''}): not writing "
              f"{dest}; rerun with --fresh for a full measurement", flush=True)
        return summary, None
    os.makedirs(os.path.dirname(dest), exist_ok=True)
    with open(dest, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"wrote {dest}", flush=True)
    return summary, dest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", default="binarized_mnist",
                    choices=sorted(SIZES),
                    help="which reference data pipeline to rehearse at real "
                         "file sizes")
    ap.add_argument("--checkpoint-every-passes", type=int, default=200)
    ap.add_argument("--data-dir", default=DATA_DIR)
    ap.add_argument("--fresh", action="store_true",
                    help="ignore existing checkpoints (default resumes)")
    ap.add_argument("--passes-scale", type=float, default=1.0,
                    help="scale every stage's passes (a scaled run writes "
                         "..._scaled.json and its gap is not held)")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the kernels' plain "
                         "versions")
    ap.add_argument("--check", action="store_true",
                    help=f"exit 1 when a complete, fresh, unscaled run's "
                         f"final NLL lies more than {BOUND} nats from JAX's")
    args = ap.parse_args(argv)
    summary, _ = run(args.dataset, data_dir=args.data_dir,
                     checkpoint_every_passes=args.checkpoint_every_passes,
                     fresh=args.fresh, passes_scale=args.passes_scale,
                     device=args.device)
    if args.check and summary["held"] and not summary["within_bound"]:
        print(f"CHECK FAILED: gap {summary['gap']:+.3f} exceeds {BOUND}",
              flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

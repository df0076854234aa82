#!/usr/bin/env python3
"""The replication suite and the seed studies on the port: the full
8-stage Burda schedule through the port's staged driver
(``experiment.run_experiment``), on the card unless ``--device cpu``,
held against the JAX package's committed 8-stage digits runs.

    python3 scripts/torch_run_replication.py --seed-study --scaled --seeds 0,1,2,3,4
    python3 scripts/torch_run_replication.py --bf16-study --seeds 0,1,2,3,4
    python3 scripts/torch_run_replication.py --seed-study        # unscaled, seeds 1-2
    python3 scripts/torch_run_replication.py [--only SUBSTRING]  # the main suite
    python3 scripts/torch_run_replication.py --check   # the verdict file

The run lists are the JAX script's (``scripts/run_replication.py``): the
same names, architectures, objectives, seeds and ``eval_batch_size``, every
run with ``save_figures=False`` and ``resume=False`` and its logs and
checkpoints in a temporary directory. Each study writes its rows beside
JAX's summary under a name of its own (:data:`OUTPUTS`), merged by run
name so that ``--only`` splits add to one file. Every row carries JAX's
fields, the NLL and the IWAE bound after each stage, the steps, B1/B2's
launches and the card's name and power limit (``nvidia-smi``).

``--check`` writes ``results/torch_replication_check.json``:

* gated, the two scaled studies (fp32 and bf16, seeds 0-4 on each side):
  for each configuration the port's mean final NLL lies within
  ``max(2, 3 * sqrt(2) * se)`` of JAX's, se the standard error of JAX's
  mean over its seeds; and on the port's own seeds, for each depth and
  dtype, IWAE k=50's mean lies below VAE k=1's by a one-sided Welch t test
  at 0.05 (:func:`welch_one_sided`). A miss is reported as a miss;
* reported beside JAX's rows, not gated (one or two JAX seeds): the
  unscaled seed study, the main suite and the STL/PIWAE runs of
  ``scripts/torch_estimator_convergence.py``, with final and best NLL.

The JAX rows of the unscaled schedule were named before ``passes_scale``
joined the science fields, so their names hash the fields less that one
(:func:`jax_row_name`); the scaled and ``digits_gray`` rows match
``run_name()`` itself. The three synthetic rows are comparable because
both packages make the same synthetic data, byte for byte (a CPU test
holds it).

``--torch-check`` and ``--tf2-check`` of the JAX script are not ported:
the eager oracles are held against the port on the card by
``chip_smoke.py`` phase 17 and the JAX package by
``scripts/torch_digits_cross_check.py``.

``--tiny`` runs test widths, 2 stages and 2 batches a pass: seconds on the
CPU; its summaries go under ``--results-dir``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

from iwae_replication_project_tpu_torch.utils.config import (  # noqa: E402
    SCIENCE_FIELDS, ExperimentConfig, _int_list)

RESULTS = HERE / "results"

ARCH_1L = dict(n_hidden_encoder=(200,), n_hidden_decoder=(200,),
               n_latent_encoder=(50,), n_latent_decoder=(784,))
ARCH_2L = dict(n_hidden_encoder=(200, 100), n_hidden_decoder=(100, 200),
               n_latent_encoder=(100, 50), n_latent_decoder=(100, 784))

#: the main suite and the fp32 studies run in fp32, as JAX's do
SUITE_DTYPE = "float32"

#: study -> (the port's summary, JAX's summary)
OUTPUTS = {
    "suite": ("torch_summary.json", "summary.json"),
    "seeds": ("torch_summary_seeds.json", "summary_seeds.json"),
    "scaled": ("torch_summary_seeds_scaled.json", "summary_seeds_scaled.json"),
    "bf16": ("torch_summary_seeds_scaled_bf16.json",
             "summary_seeds_scaled_bf16.json"),
    "quick": ("torch_summary_quick.json", None),
}
CHECK = "torch_replication_check.json"
#: scripts/torch_estimator_convergence.py's outputs beside JAX's
CONVERGENCE = {"STL": ("torch_convergence_stl.json", "convergence_stl.json"),
               "PIWAE": ("torch_convergence_piwae.json",
                         "convergence_piwae.json")}

#: the gate: 3 standard errors of a difference of two means whose spread is
#: JAX's, and never under 2 nats; the ordering test's level
BOUND_SE_FACTOR = 3.0 * math.sqrt(2.0)
BOUND_FLOOR = 2.0
ALPHA = 0.05
#: the scaled studies' configurations: (layers, loss, k)
STUDY_CONFIGS = ((1, "VAE", 1), (1, "IWAE", 50), (2, "VAE", 1),
                 (2, "IWAE", 50))

#: --tiny: test widths, 2 stages, 2 batches a pass
TINY = dict(n_hidden_encoder=(16,), n_hidden_decoder=(16,),
            n_latent_encoder=(4,), n_latent_decoder=(784,), n_stages=2,
            eval_k=4, nll_k=8, nll_chunk=4, activity_samples=8)
TINY_BATCHES = 2


def _cfg(**fields) -> ExperimentConfig:
    return ExperimentConfig(save_figures=False, resume=False, **fields)


def replication_suite(n_stages: int = 8):
    """JAX's main suite (``scripts/run_replication.py:53-124``), in its
    order: ``[(name, config)]``."""
    runs = []
    for arch_name, arch in (("1L", ARCH_1L), ("2L", ARCH_2L)):
        for loss, k in (("VAE", 1), ("VAE", 50), ("IWAE", 5), ("IWAE", 50)):
            runs.append((f"digits-{arch_name}-{loss}-k{k}", _cfg(
                dataset="digits", allow_synthetic=False, loss_function=loss,
                k=k, n_stages=n_stages, eval_batch_size=99, **arch)))
    for name, kw in (
            ("digits-1L-Lalpha0.5-k50", dict(loss_function="L_alpha",
                                             alpha=0.5)),
            ("digits-1L-Lmedian-k50", dict(loss_function="L_median")),
            ("digits-1L-Lpower3-k50", dict(loss_function="L_power_p", p=3.0)),
            ("digits-1L-CIWAE-b0.25-k50", dict(loss_function="CIWAE",
                                               beta=0.25)),
            ("digits-1L-MIWAE-10x5", dict(loss_function="MIWAE", k2=5)),
    ):
        runs.append((name, _cfg(dataset="digits", allow_synthetic=False,
                                n_stages=n_stages, eval_batch_size=99,
                                **{"k": 50, **ARCH_1L, **kw})))
    runs.append(("digits-1L-DReG-k50", _cfg(
        dataset="digits", allow_synthetic=False, loss_function="DReG", k=50,
        n_stages=n_stages, eval_batch_size=99, **ARCH_1L)))
    runs.append(("digits-1L-VAEtoIWAE-k50", _cfg(
        dataset="digits", allow_synthetic=False, loss_function="VAE",
        switch_stage=5, switch_loss="IWAE", k=50, n_stages=n_stages,
        eval_batch_size=99, **ARCH_1L)))
    for loss, k in (("VAE", 50), ("IWAE", 50)):
        runs.append((f"synthetic-2L-{loss}-k{k}", _cfg(
            dataset="binarized_mnist", allow_synthetic=True,
            loss_function=loss, k=k, n_stages=n_stages, **ARCH_2L)))
    runs.append(("synthetic-stochbin-2L-IWAE-k50", _cfg(
        dataset="mnist", allow_synthetic=True, loss_function="IWAE", k=50,
        n_stages=n_stages, **ARCH_2L)))
    for loss, k in (("VAE", 1), ("IWAE", 50)):
        runs.append((f"digitsgray-1L-{loss}-k{k}", _cfg(
            dataset="digits_gray", allow_synthetic=False, loss_function=loss,
            k=k, n_stages=n_stages, eval_batch_size=99, **ARCH_1L)))
    for _, cfg in runs:
        cfg.compute_dtype = None  # SUITE_DTYPE
    return runs


def seed_study(seeds=(1, 2), n_stages: int = 8, passes_scale: float = 1.0,
               compute_dtype=None):
    """JAX's seed study (``scripts/run_replication.py:127-163``): VAE k=1
    and IWAE k=50 at both depths for each seed, ``-ps<scale>`` and
    ``-<dtype>`` appended to the names as JAX does."""
    runs = []
    tag = "" if passes_scale == 1.0 else f"-ps{passes_scale}"
    if compute_dtype:
        tag += f"-{compute_dtype}"
    for seed in seeds:
        for arch_name, arch in (("1L", ARCH_1L), ("2L", ARCH_2L)):
            for loss, k in (("VAE", 1), ("IWAE", 50)):
                runs.append((f"digits-{arch_name}-{loss}-k{k}-s{seed}{tag}",
                             _cfg(dataset="digits", allow_synthetic=False,
                                  loss_function=loss, k=k, seed=seed,
                                  n_stages=n_stages, eval_batch_size=99,
                                  passes_scale=passes_scale,
                                  compute_dtype=compute_dtype or SUITE_DTYPE,
                                  **arch)))
    return runs


def jax_row_name(cfg: ExperimentConfig) -> str:
    """The name the JAX package gave these science fields before
    ``passes_scale`` was one of them: the hash of every science field but
    that one. The unscaled JAX rows (``passes_scale`` 1.0, the only
    schedule then) carry it."""
    import hashlib

    fields = {f: getattr(cfg, f) for f in SCIENCE_FIELDS
              if f != "passes_scale"}
    ident = hashlib.sha1(json.dumps(fields, sort_keys=True, default=list)
                         .encode()).hexdigest()[:8]
    return (f"{cfg.loss_function}-{len(cfg.n_hidden_encoder)}L-k_{cfg.k}"
            f"-{cfg.dataset}-s{cfg.seed}-{ident}")


def matches_jax_row(cfg: ExperimentConfig, jax_run_name: str) -> str:
    """How `cfg` matches a JAX row's ``run_name``: ``"run_name"`` (equal to
    ``cfg.run_name()``), ``"before_passes_scale"`` (:func:`jax_row_name`,
    at ``passes_scale`` 1.0 only) or ``""`` (no match)."""
    if cfg.run_name() == jax_run_name:
        return "run_name"
    if cfg.passes_scale == 1.0 and jax_row_name(cfg) == jax_run_name:
        return "before_passes_scale"
    return ""


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def run_row(name: str, cfg: ExperimentConfig, device=None,
            max_batches_per_pass=None, card=None) -> dict:
    """One run through the port's driver, its logs and checkpoints in a
    temporary directory: the summary row with JAX's fields, the per-stage
    curves, the steps and B1/B2's launches."""
    from iwae_replication_project_tpu_torch.experiment import run_experiment
    from iwae_replication_project_tpu_torch.ops import _kernels

    with tempfile.TemporaryDirectory() as d:
        cfg.log_dir, cfg.checkpoint_dir = f"{d}/runs", f"{d}/ckpt"
        _kernels.reset_launch_counts(_kernels.COUNTERS)
        t0 = time.perf_counter()
        history = run_experiment(cfg, device=device,
                                 max_batches_per_pass=max_batches_per_pass)[1]
        wall = time.perf_counter() - t0
        launches = _kernels.launch_counts(("hot_loop_fwd", "hot_loop_bwd"))
    nlls = [float(r["NLL"]) for r in history]
    best = min(range(len(nlls)), key=nlls.__getitem__)
    last = history[-1]
    train_s = sum(r["stage_train_seconds"] for r in history)
    return {
        "name": name, "run_name": cfg.run_name(),
        "dataset": cfg.dataset, "loss": cfg.loss_function, "k": cfg.k,
        "seed": cfg.seed, "layers": len(cfg.n_hidden_encoder),
        "stages": cfg.n_stages, "passes_scale": cfg.passes_scale,
        "compute_dtype": cfg.compute_dtype or "float32",
        "synthetic_data": bool(last["synthetic_data"]),
        "NLL": nlls[-1], "best_NLL": nlls[best],
        "best_stage": int(history[best]["stage"]),
        "IWAE_bound": float(last["IWAE"]), "VAE_bound": float(last["VAE"]),
        "active_units": last["number_of_active_units"],
        "pca_active_units": last["number_of_PCA_active_units"],
        "wall_seconds": wall,
        "NLL_by_stage": nlls,
        "IWAE_by_stage": [float(r["IWAE"]) for r in history],
        "steps": int(last["steps"]),
        "train_seconds": train_s,
        "ms_per_step": train_s / int(last["steps"]) * 1e3,
        "launches": launches,
        "device": "cpu" if device == "cpu" else "cuda",
        "card": card,
    }


# --------------------------------------------------------------------------
# the verdict's arithmetic
# --------------------------------------------------------------------------

def _betacf(a: float, b: float, x: float) -> float:
    """The continued fraction of the incomplete beta function (modified
    Lentz)."""
    tiny, qab, qap, qam = 1e-300, a + b, a + 1.0, a - 1.0
    c, d = 1.0, 1.0 - qab * x / qap
    d = 1.0 / (d if abs(d) > tiny else tiny)
    h = d
    for m in range(1, 300):
        m2 = 2 * m
        for aa in (m * (b - m) * x / ((qam + m2) * (a + m2)),
                   -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))):
            d = 1.0 + aa * d
            d = 1.0 / (d if abs(d) > tiny else tiny)
            c = 1.0 + aa / c
            c = c if abs(c) > tiny else tiny
            h *= d * c
        if abs(d * c - 1.0) < 1e-15:
            break
    return h


def betainc(a: float, b: float, x: float) -> float:
    """The regularized incomplete beta function I_x(a, b)."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    ln = (math.lgamma(a + b) - math.lgamma(a) - math.lgamma(b)
          + a * math.log(x) + b * math.log1p(-x))
    if x < (a + 1.0) / (a + b + 2.0):
        return math.exp(ln) * _betacf(a, b, x) / a
    return 1.0 - math.exp(ln) * _betacf(b, a, 1.0 - x) / b


def t_sf(t: float, df: float) -> float:
    """P(T > t) for Student's t with `df` degrees of freedom."""
    tail = 0.5 * betainc(df / 2.0, 0.5, df / (df + t * t))
    return tail if t > 0 else 1.0 - tail


def mean_sd(xs) -> tuple:
    """Mean and sample standard deviation (ddof 1; None for one value)."""
    n = len(xs)
    m = sum(xs) / n
    sd = math.sqrt(sum((x - m) ** 2 for x in xs) / (n - 1)) if n > 1 \
        else None
    return m, sd


def bound(jax_nlls) -> float:
    """The gate on |port mean - JAX mean|: ``max(2, 3 sqrt(2) se)``, se the
    standard error of JAX's mean over its seeds."""
    _, sd = mean_sd(jax_nlls)
    return max(BOUND_FLOOR, BOUND_SE_FACTOR * sd / math.sqrt(len(jax_nlls)))


def welch_one_sided(lower, upper) -> dict:
    """Welch's t test of H1: mean(lower) < mean(upper), unequal variances,
    Welch-Satterthwaite degrees of freedom; ``holds`` when p < ALPHA."""
    ml, sl = mean_sd(lower)
    mu, su = mean_sd(upper)
    vl, vu = sl * sl / len(lower), su * su / len(upper)
    se = math.sqrt(vl + vu)
    t = (mu - ml) / se
    df = (vl + vu) ** 2 / (vl * vl / (len(lower) - 1)
                           + vu * vu / (len(upper) - 1))
    p = t_sf(t, df)
    return {"mean_lower": ml, "mean_upper": mu, "gap": mu - ml, "t": t,
            "df": df, "p": p, "alpha": ALPHA, "holds": p < ALPHA}


def _rows(doc) -> list:
    return doc["rows"] if isinstance(doc, dict) else doc


def study_key(name: str):
    """``(layers, loss, k)`` of a seed-study run's name
    (``digits-2L-IWAE-k50-s3-ps0.2``), None for any other name."""
    import re

    m = re.fullmatch(r"digits-([12])L-(VAE|IWAE)-k(\d+)-s\d+(-.*)?", name)
    return (int(m[1]), m[2], int(m[3])) if m else None


def _by_config(rows) -> dict:
    out = {}
    for r in rows:
        out.setdefault(study_key(r["name"]), []).append(r)
    return out


def _jax_trajectories(rows) -> dict:
    """JAX's per-stage NLL of `rows` from ``results/runs/<run_name>/
    metrics.jsonl`` where the run's log is committed (the fp32 rows)."""
    out = {}
    for r in rows:
        p = RESULTS / "runs" / r["run_name"] / "metrics.jsonl"
        if p.exists():
            by_stage = {}
            for ln in p.read_text().splitlines():
                m = json.loads(ln)
                if "NLL" in m:
                    by_stage[int(m["stage"])] = m["NLL"]
            out[r["name"]] = [by_stage[s] for s in sorted(by_stage)]
    return out


def study_verdict(jax_rows, port_rows, label: str) -> dict:
    """One scaled study: per configuration the gap of the means against
    its bound; per depth the ordering on the port's seeds."""
    jax_by, port_by = _by_config(jax_rows), _by_config(port_rows)
    configs, ordering = {}, {}
    jax_traj = _jax_trajectories(jax_rows)
    for key in STUDY_CONFIGS:
        layers, loss, k = key
        name = f"{layers}L {loss} k={k}"
        j = [r["NLL"] for r in jax_by.get(key, [])]
        p = [r["NLL"] for r in port_by.get(key, [])]
        entry = {"jax_seeds": sorted(r["seed"] for r in jax_by.get(key, [])),
                 "port_seeds": sorted(r["seed"]
                                      for r in port_by.get(key, []))}
        if len(j) > 1:
            jm, jsd = mean_sd(j)
            entry.update(jax_mean=jm, jax_sd=jsd, bound=bound(j))
        if p and len(j) > 1:
            pm, psd = mean_sd(p)
            entry.update(port_mean=pm, port_sd=psd, gap=pm - entry["jax_mean"])
            entry["inside"] = abs(entry["gap"]) <= entry["bound"]
            curves = [r["NLL_by_stage"] for r in port_by[key]]
            entry["port_mean_NLL_by_stage"] = [
                sum(c[s] for c in curves) / len(curves)
                for s in range(len(curves[0]))]
            jt = [jax_traj[r["name"]] for r in jax_by[key]
                  if r["name"] in jax_traj]
            if jt:
                entry["jax_mean_NLL_by_stage"] = [
                    sum(c[s] for c in jt) / len(jt) for s in range(len(jt[0]))]
                entry["jax_runs_with_trajectories"] = len(jt)
        else:
            entry["inside"] = None
            entry["missing"] = "no port rows" if not p else "JAX seeds < 2"
        configs[name] = entry
    for layers in (1, 2):
        vae = [r["NLL"] for r in port_by.get((layers, "VAE", 1), [])]
        iwae = [r["NLL"] for r in port_by.get((layers, "IWAE", 50), [])]
        jv = [r["NLL"] for r in jax_by.get((layers, "VAE", 1), [])]
        ji = [r["NLL"] for r in jax_by.get((layers, "IWAE", 50), [])]
        o = welch_one_sided(iwae, vae) if len(vae) > 1 and len(iwae) > 1 \
            else {"holds": None, "missing": "fewer than 2 port seeds"}
        o["jax_gap"] = mean_sd(jv)[0] - mean_sd(ji)[0] if jv and ji else None
        ordering[f"{layers}L"] = o
    return {"study": label, "configs": configs,
            "ordering_IWAE50_below_VAE1": ordering,
            "all_inside": all(c["inside"] is True for c in configs.values()),
            "all_ordered": all(o["holds"] is True for o in ordering.values())}


def reported_rows(jax_rows, port_rows) -> list:
    """Rows of one JAX seed (or two) beside the port's of the same name:
    final and best NLL, best stage, and the final gap. Not gated."""
    port = {r["name"]: r for r in port_rows}
    out = []
    for j in jax_rows:
        p = port.get(j["name"])
        e = {"name": j["name"], "jax_run_name": j["run_name"],
             "jax_NLL": j["NLL"], "jax_best_NLL": j["best_NLL"],
             "jax_best_stage": j["best_stage"],
             "synthetic_data": j["synthetic_data"]}
        if p is None:
            e["port"] = "not run"
        else:
            e.update(port_NLL=p["NLL"], port_best_NLL=p["best_NLL"],
                     port_best_stage=p["best_stage"],
                     gap_NLL=p["NLL"] - j["NLL"],
                     gap_best_NLL=p["best_NLL"] - j["best_NLL"],
                     port_NLL_by_stage=p["NLL_by_stage"],
                     port_wall_seconds=p["wall_seconds"], card=p.get("card"))
        out.append(e)
    return out


def _load(path: Path):
    return json.loads(path.read_text()) if path.exists() else None


def check(results_dir: Path) -> dict:
    """The verdict over the port's summaries in `results_dir` against
    JAX's committed ones."""
    doc = {"bound_rule": f"per configuration max({BOUND_FLOOR}, 3*sqrt(2)*"
                         f"se of JAX's mean final NLL over its seeds)",
           "ordering_test": f"one-sided Welch t test, H1: mean final NLL of "
                            f"IWAE k=50 < VAE k=1 on the port's seeds, "
                            f"p < {ALPHA}",
           "gated": {}, "reported": {}}
    for study in ("scaled", "bf16"):
        mine, theirs = OUTPUTS[study]
        port = _load(results_dir / mine)
        doc["gated"][study] = study_verdict(
            _load(RESULTS / theirs), _rows(port) if port else [],
            "fp32" if study == "scaled" else "bf16")
    for study in ("seeds", "suite"):
        mine, theirs = OUTPUTS[study]
        port = _load(results_dir / mine)
        doc["reported"][study] = reported_rows(_load(RESULTS / theirs),
                                               _rows(port) if port else [])
    for est, (mine, theirs) in CONVERGENCE.items():
        port, jax_doc = _load(results_dir / mine), _load(RESULTS / theirs)
        e = {"jax_final_NLL": jax_doc["final_NLL"],
             "jax_best_NLL": jax_doc["best_NLL"],
             "jax_NLL_by_stage": [s["NLL"] for s in jax_doc["stages"]]}
        if port is None:
            e["port"] = "not run"
        else:
            e.update(port_final_NLL=port["final_NLL"],
                     port_best_NLL=port["best_NLL"],
                     port_NLL_by_stage=[s["NLL"] for s in port["stages"]],
                     gap_final_NLL=port["final_NLL"] - jax_doc["final_NLL"],
                     card=port.get("card"))
        doc["reported"][f"convergence_{est}"] = e
    doc["all_inside"] = all(v["all_inside"] for v in doc["gated"].values())
    doc["all_ordered"] = all(v["all_ordered"]
                             for v in doc["gated"].values())
    return doc


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------

def _write(path: Path, doc) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(doc, indent=1) + "\n")


def merge_rows(path: Path, rows: list, meta: dict) -> dict:
    """`rows` into the summary at `path`, by run name: a rerun refreshes
    its rows and keeps the rest."""
    old = _load(path)
    merged = {r["name"]: r for r in (_rows(old) if old else [])}
    merged.update({r["name"]: r for r in rows})
    doc = dict(meta, rows=list(merged.values()))
    doc["cards"] = sorted({r["card"] for r in doc["rows"] if r.get("card")})
    _write(path, doc)
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="3 stages instead of 8 (results/"
                         "torch_summary_quick.json)")
    ap.add_argument("--only", default=None,
                    help="substring filter on run names")
    ap.add_argument("--seed-study", action="store_true")
    ap.add_argument("--scaled", action="store_true",
                    help="with --seed-study: passes_scale=0.2")
    ap.add_argument("--seeds", default=None, type=_int_list)
    ap.add_argument("--bf16-study", action="store_true",
                    help="the scaled seed study with bf16 operands")
    ap.add_argument("--check", action="store_true",
                    help="write the verdict file from the summaries")
    ap.add_argument("--tiny", action="store_true",
                    help="test widths, 2 stages, 2 batches a pass")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    ap.add_argument("--results-dir", default=str(RESULTS),
                    help="where the port's summaries and verdict go")
    ns = ap.parse_args(argv)
    out_dir = Path(ns.results_dir)
    if ns.scaled and not ns.seed_study:
        ap.error("--scaled only applies to --seed-study")
    if ns.seeds is not None and not (ns.seed_study or ns.bf16_study):
        ap.error("--seeds only applies to --seed-study / --bf16-study")
    if ns.check:
        doc = check(out_dir)
        _write(out_dir / CHECK, doc)
        for study, v in doc["gated"].items():
            for name, c in v["configs"].items():
                print(f"{study} {name}: port {c.get('port_mean')} JAX "
                      f"{c.get('jax_mean')} gap {c.get('gap')} bound "
                      f"{c.get('bound')} inside {c['inside']}")
            for depth, o in v["ordering_IWAE50_below_VAE1"].items():
                print(f"{study} {depth}: IWAE k=50 below VAE k=1 "
                      f"{o['holds']} (p {o.get('p')})")
        print(f"wrote {out_dir / CHECK}; all inside {doc['all_inside']}, "
              f"all ordered {doc['all_ordered']}")
        return 0

    n_stages = 3 if ns.quick else 8
    seeds = ns.seeds
    if ns.bf16_study:
        study = "bf16"
        suite = seed_study(seeds or (0, 1, 2), n_stages, 0.2, "bfloat16")
    elif ns.seed_study and ns.scaled:
        study = "scaled"
        suite = seed_study(seeds or (0, 1, 2), n_stages, 0.2)
    elif ns.seed_study:
        study = "seeds"
        seeds = tuple(s for s in (seeds or (1, 2)) if s != 0)
        if not seeds:
            ap.error("unscaled --seed-study cannot run seed 0 (it is the "
                     "main suite's identity); pass --scaled or other seeds")
        suite = seed_study(seeds, n_stages)
    else:
        study = "suite"
        suite = replication_suite(n_stages)
    if ns.quick:
        study = "quick"
    if ns.tiny:
        for _, cfg in suite:
            for f, v in TINY.items():
                setattr(cfg, f, v)
            cfg.k = min(cfg.k, 4)
            cfg.k2 = min(cfg.k2, 2)
            if cfg.switch_stage is not None:
                cfg.switch_stage = min(cfg.switch_stage, cfg.n_stages)
    card = None if ns.device == "cpu" else card_name()
    import torch

    meta = {"package": "iwae_replication_project_tpu_torch",
            "device": ns.device or "cuda", "torch": torch.__version__,
            "tiny": ns.tiny}
    path = out_dir / OUTPUTS[study][0]
    rows = []
    for name, cfg in suite:
        if ns.only and ns.only not in name:
            continue
        print(f"=== {name} ({cfg.n_stages} stages, run {cfg.run_name()})",
              flush=True)
        row = run_row(name, cfg, ns.device,
                      TINY_BATCHES if ns.tiny else None, card)
        rows.append(row)
        merge_rows(path, [row], meta)
        print(f"--- {name}: NLL {row['NLL']:.3f} (best {row['best_NLL']:.3f}"
              f" at stage {row['best_stage']}) by stage "
              f"{[round(v, 3) for v in row['NLL_by_stage']]} active "
              f"{row['active_units']} in {row['wall_seconds']:.1f} s, "
              f"{row['ms_per_step']:.4f} host ms per step, launches "
              f"{row['launches']} {card or ''}", flush=True)
    print(f"wrote {path} ({len(rows)} runs)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

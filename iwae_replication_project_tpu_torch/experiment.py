"""The staged experiment (port of ``experiment.py``'s stage loop,
:87-431).

For each Burda stage: set the stage's learning rate (the Adam moments carry
over), take the objective in effect (objective switching included), run the
stage's passes and collect the per-pass mean loss and the gradient-SNR
scalars. Each pass is one :func:`..training.epoch.make_epoch_fn` call whose
losses stay on the device; the loop fetches them once per stage. Then the
stage is evaluated on the test set as the JAX experiment does (:352-407): the
full suite of :func:`..evaluation.training_statistics` (one fetch) and, with
diagnostics on, :func:`..telemetry.diagnostics.estimator_diagnostics`,
fetched with the grad-SNR scalars. Evaluation draws from its own generators
(:func:`..evaluation.metrics.eval_generator`), never from the training
stream.

Checkpoints and resume, logging, figures, preemption grace, the mesh and the
command line are later slices.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from iwae_replication_project_tpu_torch.data import load_dataset
from iwae_replication_project_tpu_torch.evaluation.metrics import (
    eval_generator,
    training_statistics,
)
from iwae_replication_project_tpu_torch.telemetry.diagnostics import (
    estimator_diagnostics,
)
from iwae_replication_project_tpu_torch.telemetry.registry import get_registry
from iwae_replication_project_tpu_torch.training import (
    burda_stages,
    create_train_state,
    set_learning_rate,
)
from iwae_replication_project_tpu_torch.training.epoch import make_epoch_fn
from iwae_replication_project_tpu_torch.utils.config import ExperimentConfig
from iwae_replication_project_tpu_torch.utils.device import resolve_device
from iwae_replication_project_tpu_torch.utils.sizes import largest_divisor_leq


def run_experiment(cfg: ExperimentConfig,
                   max_batches_per_pass: Optional[int] = None, device=None):
    """Run the staged experiment; returns ``(state, history)``.

    `device` None means the card (a missing card raises); pass ``"cpu"`` to
    run on the CPU, where the kernels use their plain versions.
    `max_batches_per_pass` cuts the training set to that many batches, for
    smoke runs. ``history`` has one dict per stage: ``stage``,
    ``learning_rate``, ``objective``, ``k``, ``passes``, ``steps`` (total so
    far), ``pass_losses`` (per-pass mean loss), ``stage_train_seconds``
    (host clock over the passes, ending in their one fetch), the eval
    results of ``training_statistics`` (the seven scalars, ``LL_pruned``,
    ``nll_chunk``, ``eval_batch``, ``kernel_path``),
    ``number_of_active_units`` and ``number_of_PCA_active_units``,
    ``stage_eval_seconds`` (host clock over the evaluation), with
    diagnostics on the ``diag/*`` scalars (the estimator diagnostics and the
    grad SNR of the stage's last pass), and ``synthetic_data``.
    """
    dev = resolve_device(device)
    ds = load_dataset(cfg.dataset, data_dir=cfg.data_dir,
                      allow_synthetic=cfg.allow_synthetic)
    model_cfg = cfg.model_config(dev)
    stages = burda_stages(cfg.n_stages, cfg.passes_scale)
    state = create_train_state(cfg.seed, model_cfg,
                               output_bias=ds.output_bias, lr=stages[0][1],
                               device=dev, eps=cfg.adam_eps)
    n_train = len(ds.x_train)
    if max_batches_per_pass is not None:
        n_train = min(n_train, max_batches_per_pass * cfg.batch_size)
    x_train = torch.as_tensor(ds.x_train[:n_train].reshape(n_train, -1),
                              dtype=torch.float32).to(dev)
    n_test = len(ds.x_test)
    x_test = torch.as_tensor(ds.x_test.reshape(n_test, -1),
                             dtype=torch.float32).to(dev)
    eval_batch = min(cfg.eval_batch_size, n_test)
    stoch_bin = ds.binarization == "stochastic"
    diag_cfg = cfg.diagnostics_config()
    epoch_fns = {}  # one per active objective (switching changes it)

    history = []
    for stage, lr, passes in stages:
        state = set_learning_rate(state, lr)
        spec = cfg.objective_spec(stage)
        if spec not in epoch_fns:
            epoch_fns[spec] = make_epoch_fn(
                spec, model_cfg, n_train, cfg.batch_size,
                stochastic_binarization=stoch_bin, diagnostics=diag_cfg)
        epoch = epoch_fns[spec]
        t0 = time.perf_counter()
        pass_means, diag = [], None
        for _ in range(passes):
            state, out = epoch(state, x_train)
            if diag_cfg is not None:
                out, diag = out
            pass_means.append(out.mean())
        means = torch.stack(pass_means).cpu()  # the stage's one fetch
        row = {"stage": stage, "learning_rate": lr, "objective": spec.name,
               "k": spec.k, "passes": passes, "steps": state.step,
               "pass_losses": [float(v) for v in means],
               "stage_train_seconds": time.perf_counter() - t0,
               "synthetic_data": bool(ds.synthetic)}

        t_eval = time.perf_counter()
        res, res2 = training_statistics(
            state.params, model_cfg, x_test, cfg.eval_k,
            batch_size=eval_batch, nll_k=cfg.nll_k, nll_chunk=cfg.nll_chunk,
            activity_samples=cfg.activity_samples,
            generator=eval_generator(cfg.seed, stage, dev))
        row.update(res)
        row["number_of_active_units"] = res2["number_of_active_units"]
        row["number_of_PCA_active_units"] = \
            res2["number_of_PCA_active_units"]
        if diag_cfg is not None:
            ebs = largest_divisor_leq(n_test, eval_batch)
            diag_vals = estimator_diagnostics(
                state.params, model_cfg,
                x_test.reshape(n_test // ebs, ebs, -1), cfg.eval_k, diag_cfg,
                generator=eval_generator(cfg.seed, 30_000 + stage, dev))
            diag_vals.update(diag)  # the grad SNR of the stage's last pass
            fetched = torch.stack([v.float() for v in diag_vals.values()])
            reg = get_registry()
            for key, v in zip(diag_vals, fetched.cpu().tolist()):
                row[key] = v
                reg.gauge(key).set(v)
        row["stage_eval_seconds"] = time.perf_counter() - t_eval
        history.append(row)
        print(f"stage {stage}: lr={lr:.2e} objective {spec.name} "
              f"k={spec.k} passes={passes} steps={state.step} "
              f"loss={row['pass_losses'][-1]:.4f} NLL={row['NLL']:.4f} "
              f"IWAE={row['IWAE']:.4f} active={row['number_of_active_units']}",
              flush=True)
    return state, history

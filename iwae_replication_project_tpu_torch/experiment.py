"""The staged training loop (port of ``experiment.py``'s training loop,
:87-350).

For each Burda stage: set the stage's learning rate (the Adam moments carry
over), take the objective in effect (objective switching included), run the
stage's passes and collect the per-pass mean loss and the gradient-SNR
scalars. Each pass is one :func:`..training.epoch.make_epoch_fn` call whose
losses stay on the device; the loop fetches them once per stage.

Checkpoints and resume, the evaluation suite, logging, figures, preemption
grace, the mesh and the command line are later slices.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from iwae_replication_project_tpu_torch.data import load_dataset
from iwae_replication_project_tpu_torch.training import (
    burda_stages,
    create_train_state,
    set_learning_rate,
)
from iwae_replication_project_tpu_torch.training.epoch import make_epoch_fn
from iwae_replication_project_tpu_torch.utils.config import ExperimentConfig
from iwae_replication_project_tpu_torch.utils.device import resolve_device


def run_experiment(cfg: ExperimentConfig,
                   max_batches_per_pass: Optional[int] = None, device=None):
    """Run the staged experiment; returns ``(state, history)``.

    `device` None means the card (a missing card raises); pass ``"cpu"`` to
    run on the CPU, where the kernels use their plain versions.
    `max_batches_per_pass` cuts the training set to that many batches, for
    smoke runs. ``history`` has one dict per stage: ``stage``,
    ``learning_rate``, ``objective``, ``k``, ``passes``, ``steps`` (total so
    far), ``pass_losses`` (per-pass mean loss), ``train_seconds`` (host clock
    over the stage, ending in the stage's one fetch), the ``diag/grad_snr*``
    scalars of the stage's last pass when diagnostics are on, and
    ``synthetic_data``.
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
               "train_seconds": time.perf_counter() - t0,
               "synthetic_data": bool(ds.synthetic)}
        if diag is not None:
            row.update({key: float(v) for key, v in diag.items()})
        history.append(row)
        print(f"stage {stage}: lr={lr:.2e} objective {spec.name} "
              f"k={spec.k} passes={passes} steps={state.step} "
              f"loss={row['pass_losses'][-1]:.4f}", flush=True)
    return state, history

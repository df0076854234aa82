"""One training pass over the data (port of ``training/epoch.py``).

The training set stays on the device. The shuffle (``torch.randperm``) and
the stochastic Bernoulli re-binarization draw on the device from the state's
generator, batches are drop-remainder, and the per-step losses are written
into one device tensor: there is no host sync inside a pass, and the caller
fetches one tensor per pass.

With a :class:`~..telemetry.diagnostics.DiagnosticsConfig` the pass also
accumulates the first and second gradient moments over its trailing
``snr_window`` steps and returns the gradient-SNR scalars next to the losses.

Where the JAX epoch is one ``lax.scan`` dispatch, this is a Python loop of
eager steps; capturing the epoch as a CUDA graph, and running several epochs
per call (``epochs_per_call``), are later work.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from iwae_replication_project_tpu_torch.models import iwae as model
from iwae_replication_project_tpu_torch.objectives import ObjectiveSpec
from iwae_replication_project_tpu_torch.telemetry.diagnostics import (
    DiagnosticsConfig,
    grad_accum_init,
    grad_accum_update,
    grad_snr_summary,
)
from iwae_replication_project_tpu_torch.training.train_step import (
    make_train_step,
)


def make_epoch_fn(spec: ObjectiveSpec, cfg: model.ModelConfig, n_train: int,
                  batch_size: int, stochastic_binarization: bool = False,
                  shuffle: bool = True,
                  diagnostics: Optional[DiagnosticsConfig] = None
                  ) -> Callable:
    """Build ``epoch(state, x_train) -> (state, losses)``.

    `x_train` is the full ``[n_train, x_dim]`` set on the state's device;
    ``losses`` is a ``[n_train // batch_size]`` device tensor. With
    `diagnostics` enabled the second value is ``(losses, {"diag/grad_snr*":
    0-d tensors})`` over the trailing ``min(snr_window, n_batches)`` steps.

    For replaying another implementation's draws, ``epoch`` takes them
    injected: ``perm`` (the ``[n_train]`` permutation), ``noise`` (per step,
    the list of encoder noise tensors) and ``uniforms`` (per step, the
    ``[batch_size, x_dim]`` uniforms of the binarization:
    ``batch = (u < batch)``).
    """
    n_batches = n_train // batch_size
    if n_batches == 0:
        raise ValueError(f"batch_size={batch_size} exceeds n_train={n_train}")
    diag_on = diagnostics is not None
    window = min(diagnostics.snr_window, n_batches) if diag_on else 0
    step = make_train_step(spec, cfg)

    def epoch(state, x_train: torch.Tensor, *,
              perm: Optional[torch.Tensor] = None,
              noise: Optional[Sequence[Sequence[torch.Tensor]]] = None,
              uniforms: Optional[Sequence[torch.Tensor]] = None):
        dev, gen = x_train.device, state.generator
        if perm is None:
            perm = (torch.randperm(n_train, generator=gen, device=dev)
                    if shuffle else torch.arange(n_train, device=dev))
        idx = perm[: n_batches * batch_size].reshape(n_batches, batch_size)
        losses = torch.empty(n_batches, dtype=torch.float32, device=dev)
        acc = grad_accum_init(state.params) if diag_on else None
        for i in range(n_batches):
            batch = x_train[idx[i]]
            if stochastic_binarization:
                u = (torch.rand(batch.shape, generator=gen, device=dev)
                     if uniforms is None else uniforms[i])
                batch = (u < batch).to(torch.float32)
            state, metrics = step(state, batch,
                                  eps=None if noise is None else noise[i])
            losses[i] = metrics["loss"]
            if diag_on:
                grad_accum_update(acc, metrics["grads"],
                                  include=i >= n_batches - window)
        if not diag_on:
            return state, losses
        return state, (losses, grad_snr_summary(*acc, window))

    epoch.__name__ = epoch.__qualname__ = f"epoch_{spec.name}_k{spec.k}"
    return epoch

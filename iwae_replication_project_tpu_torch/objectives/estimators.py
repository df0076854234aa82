"""Variational-bound reducers of the ``[k, B]`` log-weights (port of
``objectives/estimators.py``: ``vae_bound``, ``iwae_per_example`` and
``iwae_bound``; the other objectives come with the training slice)."""

from __future__ import annotations

import torch

from iwae_replication_project_tpu_torch.ops.logsumexp import logmeanexp


def vae_bound(log_w: torch.Tensor) -> torch.Tensor:
    """k-sample MC estimate of the ELBO: mean over samples and batch."""
    return torch.mean(log_w)


def iwae_per_example(log_w: torch.Tensor) -> torch.Tensor:
    """``[B]`` per-example k-sample bound ``logmeanexp_k(log w)``: what the
    serving ``score`` op returns per request."""
    return logmeanexp(log_w, dim=0)


def iwae_bound(log_w: torch.Tensor) -> torch.Tensor:
    """L_k = mean_B[ log mean_k exp(log w) ], max-stabilized."""
    return torch.mean(iwae_per_example(log_w))

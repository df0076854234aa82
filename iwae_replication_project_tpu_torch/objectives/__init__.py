"""Variational objectives (port of ``objectives/``)."""

from iwae_replication_project_tpu_torch.objectives.estimators import (
    OBJECTIVE_NAMES,
    ObjectiveSpec,
    alpha_bound,
    bound_from_log_weights,
    ciwae_bound,
    iwae_bound,
    median_bound,
    miwae_bound,
    objective_bound,
    power_bound,
    vae_bound,
    vae_v1_bound,
)
from iwae_replication_project_tpu_torch.objectives.gradients import (
    objective_value_and_grad,
)

__all__ = [
    "ObjectiveSpec",
    "OBJECTIVE_NAMES",
    "vae_bound",
    "iwae_bound",
    "miwae_bound",
    "ciwae_bound",
    "power_bound",
    "median_bound",
    "alpha_bound",
    "vae_v1_bound",
    "bound_from_log_weights",
    "objective_bound",
    "objective_value_and_grad",
]

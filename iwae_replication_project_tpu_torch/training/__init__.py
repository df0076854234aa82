"""Training (port of ``training/``): the step, the epoch, the Burda stages."""

from iwae_replication_project_tpu_torch.training.schedule import (
    burda_stage_lr,
    burda_stages,
)
from iwae_replication_project_tpu_torch.training.train_step import (
    TrainState,
    create_train_state,
    make_adam,
    make_train_step,
    set_learning_rate,
)

__all__ = [
    "TrainState",
    "create_train_state",
    "make_train_step",
    "make_adam",
    "set_learning_rate",
    "burda_stage_lr",
    "burda_stages",
]

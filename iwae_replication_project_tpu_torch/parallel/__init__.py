"""Data and sample parallelism over ``torch.distributed`` (port of
``parallel/``): the ``(dp, sp)`` mesh, the sharded step, epoch and
evaluation, the processes and their group, and the DDP-placed step."""

from iwae_replication_project_tpu_torch.parallel import multihost
from iwae_replication_project_tpu_torch.parallel.dp import (
    distributed_logmeanexp,
    make_parallel_epoch_fn,
    make_parallel_train_step,
    make_parallel_value_and_grad,
    parallel_train_state,
    replicate,
    shard_batch,
)
from iwae_replication_project_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    MeshAxes,
    make_mesh,
)

__all__ = [
    "AXES",
    "Mesh",
    "MeshAxes",
    "make_mesh",
    "make_parallel_epoch_fn",
    "make_parallel_train_step",
    "make_parallel_value_and_grad",
    "parallel_train_state",
    "replicate",
    "shard_batch",
    "distributed_logmeanexp",
    "multihost",
]

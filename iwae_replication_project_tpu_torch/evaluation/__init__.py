"""The evaluation suite (port of ``evaluation/``): the seven eval scalars
with the streamed k=5000 NLL, active units and the pruned NLL."""

from iwae_replication_project_tpu_torch.evaluation.activity import (  # noqa: F401
    active_units,
    nll_without_inactive_units,
    pca_eigenvalues,
    posterior_mean_activity,
)
from iwae_replication_project_tpu_torch.evaluation.metrics import (  # noqa: F401
    SCALAR_NAMES,
    batch_metrics,
    dataset_scalars,
    eval_generator,
    reconstruction_loss,
    streaming_log_px,
    streaming_nll,
    training_statistics,
)

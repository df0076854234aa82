"""The IWAE model family (port of ``models/``)."""

from iwae_replication_project_tpu_torch.models.iwae import (  # noqa: F401
    ModelConfig,
    decode_probs,
    encode,
    generate_x,
    init_params,
    log_prior,
    log_px_given_h,
    log_weights,
    log_weights_and_aux,
    reconstruct_probs,
)

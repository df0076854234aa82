"""Datasets (port of ``data/``: the numpy loaders; the host batch pipeline is
not needed, since the epoch shuffles and binarizes on the device)."""

from iwae_replication_project_tpu_torch.data.loaders import (
    DATASETS,
    Dataset,
    load_dataset,
    output_bias_from_pixel_means,
)

__all__ = [
    "DATASETS",
    "Dataset",
    "load_dataset",
    "output_bias_from_pixel_means",
]

"""Experiment configuration (port of ``utils/config.py``, reduced to the
fields the zoo presets set and ``model_config()`` reads: architecture,
objective, seed, ``compute_dtype``, ``serving_precision``, ``likelihood`` and
``fused_likelihood``; the training, evaluation and execution knobs come with
their slices)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from iwae_replication_project_tpu_torch.models.iwae import ModelConfig
from iwae_replication_project_tpu_torch.utils.dtypes import validate_precision


@dataclasses.dataclass
class ExperimentConfig:
    dataset: str = "binarized_mnist"

    # architecture (the 2-layer flagship by default)
    n_hidden_encoder: Tuple[int, ...] = (200, 100)
    n_hidden_decoder: Tuple[int, ...] = (100, 200)
    n_latent_encoder: Tuple[int, ...] = (100, 50)
    n_latent_decoder: Tuple[int, ...] = (100, 784)

    # objective
    loss_function: str = "IWAE"
    k: int = 50
    p: float = 1.0
    alpha: float = 1.0
    beta: float = 0.5
    k2: int = 1

    seed: int = 0
    passes_scale: float = 1.0
    switch_stage: Optional[int] = None
    switch_loss: Optional[str] = None
    switch_k: Optional[int] = None

    # None (fp32 matmuls) | "bfloat16" (bf16 operands, fp32 accumulation);
    # "float32" normalizes to None. bf16 is the production default.
    compute_dtype: Optional[str] = "bfloat16"
    # serving precision policy handed to the engine by zoo.serving_engine
    serving_precision: Optional[str] = None
    # "logits": exact x*l - softplus(l); "clamp": sigmoid + reference clamp
    likelihood: str = "logits"
    # the fused hot-loop dispatcher; None = auto: "logits" and CUDA
    fused_likelihood: Optional[bool] = None

    def __post_init__(self):
        if self.compute_dtype == "float32":
            self.compute_dtype = None
        if self.compute_dtype not in (None, "bfloat16"):
            raise ValueError(
                f"compute_dtype must be None, 'float32' or 'bfloat16', got "
                f"{self.compute_dtype!r}")
        if self.serving_precision is not None:
            validate_precision(self.serving_precision)

    def model_config(self, device=None) -> ModelConfig:
        """The architecture as a :class:`ModelConfig`. With
        ``fused_likelihood`` left None the hot loop is fused when the
        likelihood is ``"logits"`` and the model runs on CUDA (`device`, or
        the presence of a CUDA device when `device` is None)."""
        fused = self.fused_likelihood
        if fused is None:
            on_cuda = torch.device(device).type == "cuda" \
                if device is not None else torch.cuda.is_available()
            fused = self.likelihood == "logits" and on_cuda
        return ModelConfig(
            n_hidden_enc=tuple(self.n_hidden_encoder),
            n_latent_enc=tuple(self.n_latent_encoder),
            n_hidden_dec=tuple(self.n_hidden_decoder),
            n_latent_dec=tuple(self.n_latent_decoder),
            likelihood=self.likelihood,
            compute_dtype=self.compute_dtype,
            fused_likelihood=bool(fused),
        )

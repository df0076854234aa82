"""Experiment configuration (port of ``utils/config.py``, reduced to the
fields the zoo presets set and the ported paths read: data, architecture,
objective with switching, the training knobs of the Burda schedule, the
evaluation sizes, ``compute_dtype``, ``serving_precision``, ``likelihood``,
``fused_likelihood`` and the diagnostics; checkpoint, logging and mesh knobs
come with their slices)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from iwae_replication_project_tpu_torch.models.iwae import ModelConfig
from iwae_replication_project_tpu_torch.objectives.estimators import (
    ObjectiveSpec,
)
from iwae_replication_project_tpu_torch.utils.dtypes import validate_precision


@dataclasses.dataclass
class ExperimentConfig:
    # data
    dataset: str = "binarized_mnist"
    data_dir: str = "data"
    allow_synthetic: bool = True

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

    # training (experiment_example.py:35-40; Burda's schedule)
    batch_size: int = 100
    n_stages: int = 8
    adam_eps: float = 1e-4
    seed: int = 0
    # stage i trains max(1, round(3^(i-1) * passes_scale)) passes
    passes_scale: float = 1.0

    # objective switching: from `switch_stage` on, train with `switch_loss`
    # (and `switch_k` if given) instead of `loss_function`
    switch_stage: Optional[int] = None
    switch_loss: Optional[str] = None
    switch_k: Optional[int] = None

    # evaluation after each stage (flexible_IWAE.py:496-526); the NLL chunk
    # and the eval batch are clamped to divisors of nll_k and the test-set
    # size, and each history row records the values used
    eval_k: int = 50
    nll_k: int = 5000
    nll_chunk: int = 250
    eval_batch_size: int = 500
    activity_samples: int = 1000

    # None (fp32 matmuls) | "bfloat16" (bf16 operands, fp32 accumulation);
    # "float32" normalizes to None. bf16 is the production default.
    compute_dtype: Optional[str] = "bfloat16"
    # serving precision policy handed to the engine by zoo.serving_engine
    serving_precision: Optional[str] = None
    # "logits": exact x*l - softplus(l); "clamp": sigmoid + reference clamp
    likelihood: str = "logits"
    # the fused hot-loop dispatcher; None = auto: "logits" and CUDA
    fused_likelihood: Optional[bool] = None
    # gradient-SNR diagnostics over the trailing snr_window steps of a pass,
    # and the estimator diagnostics of each stage's evaluation
    diagnostics: bool = True
    snr_window: int = 50

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

    def diagnostics_config(self):
        """The DiagnosticsConfig training runs under, or None when
        diagnostics are off."""
        if not self.diagnostics:
            return None
        from iwae_replication_project_tpu_torch.telemetry.diagnostics import (
            DiagnosticsConfig)
        return DiagnosticsConfig(snr_window=self.snr_window)

    def objective_spec(self, stage: Optional[int] = None) -> ObjectiveSpec:
        """The objective in effect at `stage` (1-based; None -> the base
        one)."""
        name, k = self.loss_function, self.k
        if (self.switch_stage is not None and stage is not None
                and stage >= self.switch_stage):
            name = self.switch_loss or name
            k = self.switch_k if self.switch_k is not None else k
        return ObjectiveSpec(name=name, k=k, p=self.p, alpha=self.alpha,
                             beta=self.beta, k2=self.k2)

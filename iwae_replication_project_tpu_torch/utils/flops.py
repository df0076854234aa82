"""Analytic matmul-FLOP accounting and the peak tables (port of
``utils/flops.py``).

The counts are framework-free: 2 FLOPs per MAC of the model's dense layers,
backward ~= 2x forward, derived from any :class:`~..models.iwae.ModelConfig`.
Elementwise ops, sampling and reductions ride along uncounted, so a measured
MFU from these counts is a lower bound on the work done. The counts equal
the JAX module's (tests/test_torch_observability.py), not the JAX cost
records'.

The peak tables keep the JAX module's TPU rows as plain data (nothing in
the port looks them up) and add the card's rows, matched on
``torch.cuda.get_device_name``: the H100 SXM5 (``"NVIDIA H100 80GB HBM3"``,
or any name naming ``"H100 SXM"``) at its dense bf16 tensor-core peak of
989 TFLOP/s and 3.35 TB/s of HBM3. Any other card (an H100 PCIe or NVL
included) gets ``(None, reason)``: no denominator is guessed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from iwae_replication_project_tpu_torch.utils.sizes import (
    largest_divisor_leq,
)

#: per-card dense bf16 peak FLOP/s by ``torch.cuda.get_device_name``
#: substring (lower case). NVIDIA's H100 SXM5 datasheet: 989.4 TFLOP/s
#: dense bf16 on the tensor cores
PEAK_BF16_FLOPS_GPU: Tuple[Tuple[str, float], ...] = (
    ("nvidia h100 80gb hbm3", 989e12), ("h100 sxm", 989e12),
)

#: per-card HBM bandwidth (bytes/s), same matching. H100 SXM5: 3.35 TB/s
PEAK_HBM_BYTES_GPU: Tuple[Tuple[str, float], ...] = (
    ("nvidia h100 80gb hbm3", 3.35e12), ("h100 sxm", 3.35e12),
)

#: the JAX module's TPU rows, by ``device_kind`` substring in order (more
#: specific first): v2 45T, v3 123T, v4 275T, v5e 197T, v5p 459T, v6e 918T
PEAK_BF16_FLOPS: Tuple[Tuple[str, float], ...] = (
    ("v6e", 918e12), ("v6 lite", 918e12), ("trillium", 918e12),
    ("v5p", 459e12), ("v5e", 197e12), ("v5 lite", 197e12),
    ("v4", 275e12), ("v3", 123e12), ("v2", 45e12),
)

#: the JAX module's TPU HBM rows (bytes/s)
PEAK_HBM_BYTES: Tuple[Tuple[str, float], ...] = (
    ("v6e", 1640e9), ("v6 lite", 1640e9), ("trillium", 1640e9),
    ("v5p", 2765e9), ("v5e", 819e9), ("v5 lite", 819e9),
    ("v4", 1228e9), ("v3", 900e9), ("v2", 700e9),
)


def _match(name: str, table, label: str) -> Tuple[Optional[float], str]:
    low = name.lower()
    for sub, val in table:
        if sub in low:
            return val, f"{label} table: matched {sub!r} in {name!r}"
    return None, f"no {label} table entry for {name!r}"


def peak_flops_for_card(name: str) -> Tuple[Optional[float], str]:
    """``(peak_flops | None, source)`` for one ``torch.cuda.get_device_name``
    (the card rows only: a card never matches a TPU row)."""
    return _match(name, PEAK_BF16_FLOPS_GPU, "card bf16 peak")


def peak_hbm_bytes_for_card(name: str) -> Tuple[Optional[float], str]:
    """``(hbm_bytes_per_s | None, source)`` for one card name."""
    return _match(name, PEAK_HBM_BYTES_GPU, "card HBM BW")


def stochastic_block_macs(in_dim: int, hidden: int, latent: int) -> int:
    """Matmul MACs of one stochastic block per row: 2 hidden + mu/std heads
    (``models.mlp``)."""
    return in_dim * hidden + hidden * hidden + 2 * hidden * latent


def output_block_macs(in_dim: int, hidden: int, out_dim: int) -> int:
    """Matmul MACs of the decoder output block per row: 2 hidden + the logit
    layer, B1's region."""
    return in_dim * hidden + hidden * hidden + hidden * out_dim


def param_count(cfg) -> int:
    """Exact parameter count (weights + biases) of the architecture."""

    def stochastic(in_dim, hidden, latent):
        return (stochastic_block_macs(in_dim, hidden, latent)
                + 2 * hidden + 2 * latent)

    L = cfg.n_stochastic
    n = stochastic(cfg.x_dim, cfg.n_hidden_enc[0], cfg.n_latent_enc[0])
    in_dim = cfg.n_latent_enc[0]
    for i in range(1, L):
        n += stochastic(in_dim, cfg.n_hidden_enc[i], cfg.n_latent_enc[i])
        in_dim = cfg.n_latent_enc[i]
    in_dim = cfg.n_latent_enc[-1]
    for i in range(L - 1):
        n += stochastic(in_dim, cfg.n_hidden_dec[i], cfg.n_latent_dec[i])
        in_dim = cfg.n_latent_dec[i]
    n += (output_block_macs(in_dim, cfg.n_hidden_dec[-1], cfg.x_dim)
          + 2 * cfg.n_hidden_dec[-1] + cfg.x_dim)
    return n


def byte_width(dtype) -> int:
    """Bytes per element of a ``torch.dtype`` or its name (``"float32"``,
    ``"bfloat16"``, ...)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty((), dtype=dtype).element_size()


def model_param_bytes(cfg, dtype="float32") -> int:
    """Bytes of one parameter tree at `dtype`."""
    return param_count(cfg) * byte_width(dtype)


def per_row_macs(cfg) -> Tuple[int, int]:
    """``(macs_per_batch_row, macs_per_(k x batch)_row)`` of one forward: the
    first encoder block runs before the k fan-out, every other block scales
    with k."""
    L = cfg.n_stochastic
    no_k = stochastic_block_macs(cfg.x_dim, cfg.n_hidden_enc[0],
                                 cfg.n_latent_enc[0])
    per_k = 0
    in_dim = cfg.n_latent_enc[0]
    for i in range(1, L):
        per_k += stochastic_block_macs(in_dim, cfg.n_hidden_enc[i],
                                       cfg.n_latent_enc[i])
        in_dim = cfg.n_latent_enc[i]
    in_dim = cfg.n_latent_enc[-1]
    for i in range(L - 1):
        per_k += stochastic_block_macs(in_dim, cfg.n_hidden_dec[i],
                                       cfg.n_latent_dec[i])
        in_dim = cfg.n_latent_dec[i]
    per_k += output_block_macs(in_dim, cfg.n_hidden_dec[-1], cfg.x_dim)
    return no_k, per_k


def forward_flops(cfg, batch: int, k: int) -> float:
    """Analytic matmul FLOPs of one log-weights forward (MACs * 2)."""
    no_k, per_k = per_row_macs(cfg)
    return 2.0 * (batch * no_k + batch * k * per_k)


def train_step_flops(cfg, batch: int, k: int) -> float:
    """Per optimizer step: forward + ~2x-forward backward."""
    return 3.0 * forward_flops(cfg, batch, k)


def eval_suite_flops_per_image(cfg, k: int, nll_k: int,
                               nll_chunk: int) -> float:
    """Per test image through the evaluation suite: the k-sample metric
    pass, the streamed nll_k-sample NLL (each chunk re-runs the first
    encoder block) and the 1-sample reconstruction (one k=1 forward)."""
    no_k, per_k = per_row_macs(cfg)
    nll = 2.0 * ((nll_k // nll_chunk) * no_k + nll_k * per_k)
    return forward_flops(cfg, 1, k) + nll + forward_flops(cfg, 1, 1)


def serving_score_flops_per_row(cfg, k: int) -> float:
    """Per served ``score`` row: one k-sample forward."""
    return forward_flops(cfg, 1, k)


__all__ = ["PEAK_BF16_FLOPS", "PEAK_BF16_FLOPS_GPU", "PEAK_HBM_BYTES",
           "PEAK_HBM_BYTES_GPU", "byte_width", "eval_suite_flops_per_image",
           "forward_flops", "largest_divisor_leq", "model_param_bytes",
           "output_block_macs", "param_count", "peak_flops_for_card",
           "peak_hbm_bytes_for_card", "per_row_macs",
           "serving_score_flops_per_row", "stochastic_block_macs",
           "train_step_flops"]

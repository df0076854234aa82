"""Latent-unit activity diagnostics (port of ``evaluation/activity.py``;
Burda et al. §C).

A unit is *active* if the across-data variance of its posterior mean exceeds
:data:`ACTIVE_THRESHOLD` (0.01). The posterior means are Monte-Carlo estimates: a Python
loop over sample chunks of the encoder, folding each chunk's samples into a
running sum, so memory is O(chunk * N * d). Variances are the population
variance (``correction=0``, as ``jnp.var``) and the PCA covariance divides by
N, so the counts match the JAX package's at the 0.01 threshold.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from iwae_replication_project_tpu_torch.models import iwae as model
from iwae_replication_project_tpu_torch.models.mlp import (
    stochastic_block_apply,
)
from iwae_replication_project_tpu_torch.ops import distributions as dist
from iwae_replication_project_tpu_torch.ops.logsumexp import (
    OnlineLSE,
    streaming_logmeanexp,
)
from iwae_replication_project_tpu_torch.utils.sizes import largest_divisor_leq

Eps = Sequence[torch.Tensor]

#: posterior-mean variance above which a latent unit counts as active (the
#: paper's convention); the estimator diagnostics' cheap count uses it too
ACTIVE_THRESHOLD = 0.01


@torch.no_grad()
def posterior_mean_activity(params, cfg: model.ModelConfig, x: torch.Tensor,
                            n_samples: int = 1000, chunk: int = 10, *,
                            generator: Optional[torch.Generator] = None,
                            noise: Optional[Callable[[int], Eps]] = None):
    """MC posterior means E_q[h_i | x] -> per-unit variances and PCA
    eigenvalues (JAX :31-55).

    Returns ``(variances, eigenvalues)``, tuples over stochastic layers with
    entries of shape ``[n_latent_enc[i]]``. Sample chunk i draws `chunk`
    encoder samples (``noise(i)`` injects them); a chunk that does not
    divide `n_samples` is clamped to the largest divisor.
    """
    sums = posterior_sample_sums(params, cfg, x, n_samples, chunk,
                                 generator=generator, noise=noise)
    return activity_from_means([s / n_samples for s in sums])


@torch.no_grad()
def posterior_sample_sums(params, cfg: model.ModelConfig, x: torch.Tensor,
                          n_samples: int, chunk: int = 10, *,
                          generator: Optional[torch.Generator] = None,
                          noise: Optional[Callable[[int], Eps]] = None):
    """Per layer, the ``[N, d_i]`` sum of `n_samples` encoder samples, in
    chunks of `chunk` (clamped to the largest divisor of `n_samples`)."""
    chunk = largest_divisor_leq(n_samples, chunk)
    sums = [torch.zeros((x.shape[0], d), device=x.device)
            for d in cfg.n_latent_enc]
    for i in range(n_samples // chunk):
        h, _, _ = model.encode(params, cfg, x, chunk, generator=generator,
                               eps=None if noise is None else noise(i))
        for s, hi in zip(sums, h):
            s += torch.sum(hi, dim=0)
    return sums


def activity_from_means(means):
    """``(variances, eigenvalues)`` of per-layer ``[N, d_i]`` posterior
    means."""
    variances = tuple(torch.var(m, dim=0, correction=0) for m in means)
    eigenvalues = tuple(pca_eigenvalues(m) for m in means)
    return variances, eigenvalues


def pca_eigenvalues(data: torch.Tensor) -> torch.Tensor:
    """Eigenvalues (ascending) of the empirical covariance of ``[N, d]``
    data, normalised by N (JAX :58-63)."""
    centered = data - torch.mean(data, dim=0)
    cov = (centered.T @ centered) / data.shape[0]
    return torch.linalg.eigvalsh(cov)


def active_units(variances, eigenvalues
                 ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor,
                            torch.Tensor]:
    """0/1 masks per layer and the raw and PCA active-unit counts (JAX
    :66-73). The counts are ``[L]`` int64 tensors on the device, not
    Python lists, so an eval suite fetches them with its other results."""
    masks = tuple((v > ACTIVE_THRESHOLD).float() for v in variances)
    n_active = torch.stack([torch.sum(m).long() for m in masks])
    n_active_pca = torch.stack([torch.sum(e > ACTIVE_THRESHOLD)
                                for e in eigenvalues])
    return masks, n_active, n_active_pca


def _masked_log_weights(params, cfg: model.ModelConfig, x: torch.Tensor,
                        masks, k: int, *,
                        generator: Optional[torch.Generator] = None,
                        eps: Optional[Eps] = None) -> torch.Tensor:
    """Log-weights with inactive latent coordinates zeroed after sampling,
    densities evaluated at the masked values (JAX :76-95). Draws as
    ``models.iwae.encode`` does; ``eps`` injects them."""
    dt = cfg.matmul_dtype
    mu, std = stochastic_block_apply(params["enc"][0], x, cfg.std_floor, dt)
    h1 = dist.normal_sample(mu, std, (k,), generator=generator,
                            eps=None if eps is None else eps[0]) * masks[0]
    log_q = torch.sum(dist.normal_log_prob(h1, mu, std), dim=-1)
    h = [h1]
    for i in range(1, cfg.n_stochastic):
        mu, std = stochastic_block_apply(params["enc"][i], h[-1],
                                         cfg.std_floor, dt)
        hi = dist.normal_sample(mu, std, generator=generator,
                                eps=None if eps is None else eps[i]) \
            * masks[i]
        log_q = log_q + torch.sum(dist.normal_log_prob(hi, mu, std), dim=-1)
        h.append(hi)
    h = tuple(h)
    return (model.log_prior(params, cfg, h)
            + model.log_px_given_h(params, cfg, x, h[0]) - log_q)


@torch.no_grad()
def nll_without_inactive_units(params, cfg: model.ModelConfig,
                               x: torch.Tensor, masks, k: int = 5000,
                               chunk: int = 250, *,
                               generator: Optional[torch.Generator] = None,
                               noise: Optional[Callable[[int], Eps]] = None,
                               merge: Optional[Callable[[OnlineLSE],
                                                        OnlineLSE]] = None
                               ) -> torch.Tensor:
    """0-d ``-L_k`` with pruned latents, streamed in k-chunks like the
    unpruned NLL (JAX :98-119); a chunk that does not divide k is clamped to
    the largest divisor. ``noise(j)`` injects chunk j's draws; `merge` is
    :func:`..metrics.streaming_log_px`'s."""
    chunk = largest_divisor_leq(k, chunk)
    log_px = streaming_logmeanexp(
        lambda j: _masked_log_weights(params, cfg, x, masks, chunk,
                                      generator=generator,
                                      eps=None if noise is None else noise(j)),
        k, chunk, (x.shape[0],), device=x.device, merge=merge)
    return -torch.mean(log_px)

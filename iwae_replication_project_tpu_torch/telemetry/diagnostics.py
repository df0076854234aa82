"""Estimator diagnostics (port of ``telemetry/diagnostics.py``).

* Gradient SNR of the training epoch: SNR = |E[g]| / sigma[g] per
  parameter, from the first and second moments of the gradients over the
  trailing ``snr_window`` optimizer steps of an epoch (Rainforth et al.: the
  encoder's SNR decays as K grows).
* Weight-space diagnostics of evaluation: the effective sample size of the
  K self-normalised weights, ``ESS = (sum w)^2 / sum w^2``, the log-weight
  variance, the KL of q to the prior and a cheap active-units count
  (:func:`estimator_diagnostics`).

Everything stays on the device as 0-d tensors, which the experiment fetches
with its per-stage fetch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from iwae_replication_project_tpu_torch.evaluation.activity import (
    ACTIVE_THRESHOLD,
)
from iwae_replication_project_tpu_torch.models import iwae as model
from iwae_replication_project_tpu_torch.utils.tree import tree_leaves, tree_map

_SNR_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class DiagnosticsConfig:
    """The diagnostics' knobs; ``None`` in its place means diagnostics off
    (the JAX config's ``enabled`` flag)."""

    #: trailing optimizer steps in the gradient-SNR moment estimate (clamped
    #: to the steps one epoch runs)
    snr_window: int = 50

    def __post_init__(self):
        if self.snr_window < 1:
            raise ValueError(
                f"snr_window must be >= 1, got {self.snr_window}")


def grad_accum_init(params) -> Tuple:
    """Zeroed ``(sum g, sum g^2)`` accumulator trees on the params' device."""
    return (tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params),
            tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params))


def grad_accum_update(acc: Tuple, grads) -> Tuple:
    """Fold one step's grads into the ``(sum g, sum g^2)`` accumulators in
    place, as two multi-tensor ops over all leaves. The caller folds in only
    the window's steps (JAX :157-162 weights every step by a 0/1 mask)."""
    s1, s2 = acc
    g = tree_leaves(grads)
    torch._foreach_add_(tree_leaves(s1), g)
    torch._foreach_addcmul_(tree_leaves(s2), g, g)
    return acc


def _subtree_snr(sum_g, sum_sq, n: int) -> torch.Tensor:
    """Mean over parameters of |mean| / std from the accumulated moments."""
    tot, count = None, 0
    for g, q in zip(tree_leaves(sum_g), tree_leaves(sum_sq)):
        m = g / n
        var = torch.clamp_min(q / n - m * m, 0.0)
        part = torch.sum(torch.abs(m) / torch.sqrt(var + _SNR_EPS))
        tot = part if tot is None else tot + part
        count += g.numel()
    return tot / count


def grad_snr_summary(sum_g, sum_sq, n: int) -> Dict[str, torch.Tensor]:
    """Rainforth-style SNR scalars from windowed first/second grad moments of
    ``{"enc", "dec", "out"}`` trees: all parameters, the encoder subtree and
    the decoder plus output subtrees."""
    dec = ({"dec": sum_g["dec"], "out": sum_g["out"]},
           {"dec": sum_sq["dec"], "out": sum_sq["out"]})
    return {
        "diag/grad_snr": _subtree_snr(sum_g, sum_sq, n),
        "diag/grad_snr_enc": _subtree_snr(sum_g["enc"], sum_sq["enc"], n),
        "diag/grad_snr_dec": _subtree_snr(*dec, n),
    }


# --------------------------------------------------------------------------
# weight-space diagnostics: reductions of the [k, B] log-weights
# --------------------------------------------------------------------------

def ess(log_w: torch.Tensor) -> torch.Tensor:
    """Effective sample size of the K self-normalised weights per datapoint,
    ``exp(2 lse(log w) - lse(2 log w))`` along the sample axis: k for
    uniform weights, 1 when one sample dominates."""
    lse1 = torch.logsumexp(log_w, dim=0)
    lse2 = torch.logsumexp(2.0 * log_w, dim=0)
    return torch.exp(2.0 * lse1 - lse2)


def weight_diagnostics(log_w: torch.Tensor,
                       n_samples=None) -> Dict[str, torch.Tensor]:
    """Batch-mean ESS, ESS fraction and log-weight variance of one pass
    (JAX :102-144).

    ``n_samples`` is the actual sample count where the leading axis is
    padded (scalar or per-row ``[B]``): rows at or past it are masked out of
    the ESS and the variance, and the fraction divides by it. A zero count
    gives ESS 0, never NaN. ``None``: the leading axis is the count.
    """
    if n_samples is None:
        k = log_w.shape[0]
        e = torch.mean(ess(log_w))
        return {"diag/ess": e, "diag/ess_frac": e / k,
                "diag/log_weight_var": torch.mean(
                    torch.var(log_w, dim=0, correction=0))}
    n = torch.as_tensor(n_samples, dtype=log_w.dtype, device=log_w.device)
    mask = torch.arange(log_w.shape[0], device=log_w.device)[:, None] < n
    safe_n = torch.clamp_min(n, 1.0)
    masked = torch.where(mask, log_w, torch.full_like(log_w, -torch.inf))
    lse1 = torch.logsumexp(masked, dim=0)
    lse2 = torch.logsumexp(2.0 * masked, dim=0)
    # an all-masked column has lse1 = lse2 = -inf: substitute finite dummies
    # and select, so the defined answer (0 samples -> ESS 0) is not a NaN
    empty = torch.isneginf(lse1)
    zero = torch.zeros_like(lse1)
    per_row = torch.where(empty, zero, torch.exp(
        2.0 * torch.where(empty, zero, lse1) - torch.where(empty, zero, lse2)))
    lw = torch.where(mask, log_w, torch.zeros_like(log_w))
    m = torch.sum(lw, dim=0) / safe_n
    d = torch.where(mask, log_w - m, torch.zeros_like(log_w))
    return {"diag/ess": torch.mean(per_row),
            "diag/ess_frac": torch.mean(per_row / safe_n),
            "diag/log_weight_var": torch.mean(torch.sum(d * d, dim=0)
                                              / safe_n)}


@torch.no_grad()
def estimator_diagnostics(params, cfg, batches: torch.Tensor, k: int,
                          diag: DiagnosticsConfig, *,
                          generator: Optional[torch.Generator] = None,
                          noise: Optional[Callable[[int],
                                                   Sequence[torch.Tensor]]]
                          = None) -> Dict[str, torch.Tensor]:
    """Weight-space, KL and active-units diagnostics over ``[n_batches, B,
    d]`` test batches (JAX :198-246), as 0-d tensors on the device.

    One k-sample pass per batch (``noise(i)`` injects its encoder draws).
    The active-units count here is the cheap version: the across-data
    variance of the per-datapoint posterior mean over the pass's k samples;
    ``evaluation.activity`` has the reference estimator. Both count against
    :data:`~..evaluation.activity.ACTIVE_THRESHOLD`.
    """
    n_batches, batch = batches.shape[0], batches.shape[1]
    dev = batches.device
    acc = torch.zeros(3, device=dev)
    s1 = [torch.zeros(d, device=dev) for d in cfg.n_latent_enc]
    s2 = [torch.zeros(d, device=dev) for d in cfg.n_latent_enc]
    for i in range(n_batches):
        log_w, aux = model.log_weights_and_aux(
            params, cfg, batches[i], k, generator=generator,
            eps=None if noise is None else noise(i))
        w = weight_diagnostics(log_w)
        kl = torch.mean(aux["log_q"] - aux["log_prior"])
        acc = acc + torch.stack([w["diag/ess"], w["diag/log_weight_var"],
                                 kl])
        for j, h in enumerate(aux["h"]):
            m = torch.mean(h, dim=0)  # [B, d]: posterior mean per datapoint
            s1[j] = s1[j] + torch.sum(m, dim=0)
            s2[j] = s2[j] + torch.sum(m * m, dim=0)
    acc = acc / n_batches
    n = n_batches * batch
    active = torch.zeros((), device=dev)
    for s, q in zip(s1, s2):
        var = torch.clamp_min(q / n - (s / n) ** 2, 0.0)
        active = active + torch.sum(var > ACTIVE_THRESHOLD)
    return {"diag/ess": acc[0], "diag/ess_frac": acc[0] / k,
            "diag/log_weight_var": acc[1], "diag/kl_q_p": acc[2],
            "diag/active_units": active,
            "diag/active_frac": active / sum(cfg.n_latent_enc)}

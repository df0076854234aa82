"""Variational-bound estimators: reductions of the ``[k, B]`` log-weights
(port of ``objectives/estimators.py``).

===========  ==================================================================
name         bound
===========  ==================================================================
VAE          ``mean(log w)``
IWAE         ``mean_B logmeanexp_k(log w)``
VAE_V1       analytic-KL ELBO (single stochastic layer)
L_alpha      ``(1-a) E_q[log p(x|h)] + a L_VAE``
L_power_p    ``mean_B (1/p) logmeanexp_k(p log w)``
L_median     ``mean_B median_k(log w)``
CIWAE        ``b L_VAE + (1-b) L_IWAE``
MIWAE        mean of k2 independent k1-sample IWAE bounds
===========  ==================================================================

PIWAE, DReG and STL evaluate as IWAE; they change the gradient, not the
bound (:mod:`.gradients`). Every reducer works on a leading k axis and is
differentiable by autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from iwae_replication_project_tpu_torch.ops import distributions as dist
from iwae_replication_project_tpu_torch.ops.logsumexp import logmeanexp

#: every objective name accepted by the framework's dispatchers.
OBJECTIVE_NAMES = ("VAE", "IWAE", "VAE_V1", "L_alpha", "L_power_p", "L_median",
                   "CIWAE", "MIWAE", "PIWAE", "DReG", "STL")


@dataclasses.dataclass(frozen=True)
class ObjectiveSpec:
    """An objective name plus its hyperparameters (hashable).

    For MIWAE/PIWAE, ``k`` is ``k1 * k2`` with ``k2`` outer averages of
    ``k1``-sample bounds; every other objective ignores ``k2``.
    """

    name: str = "VAE"
    k: int = 50
    p: float = 1.0
    alpha: float = 1.0
    beta: float = 0.5
    k2: int = 1  # MIWAE/PIWAE outer-average count; k1 = k // k2

    def __post_init__(self):
        if self.name not in OBJECTIVE_NAMES:
            raise ValueError(f"unknown objective {self.name!r}; choose from "
                             f"{OBJECTIVE_NAMES}")
        if self.name in ("MIWAE", "PIWAE") and self.k % self.k2 != 0:
            raise ValueError(f"MIWAE/PIWAE need k2 | k, got k={self.k}, "
                             f"k2={self.k2}")


def vae_bound(log_w: torch.Tensor) -> torch.Tensor:
    """k-sample MC estimate of the ELBO: mean over samples and batch."""
    return torch.mean(log_w)


def iwae_per_example(log_w: torch.Tensor) -> torch.Tensor:
    """``[B]`` per-example k-sample bound ``logmeanexp_k(log w)``: what the
    serving ``score`` op returns per request."""
    return logmeanexp(log_w, dim=0)


def iwae_bound(log_w: torch.Tensor) -> torch.Tensor:
    """L_k = mean_B[ log mean_k exp(log w) ], max-stabilized."""
    return torch.mean(iwae_per_example(log_w))


def miwae_bound(log_w: torch.Tensor, k2: int) -> torch.Tensor:
    """Average of k2 independent k1-sample IWAE bounds (k2 == k -> VAE,
    k2 == 1 -> IWAE)."""
    k = log_w.shape[0]
    grouped = log_w.reshape(k2, k // k2, *log_w.shape[1:])
    return torch.mean(logmeanexp(grouped, dim=1))


def ciwae_bound(log_w: torch.Tensor, beta: float) -> torch.Tensor:
    """Convex combination beta*VAE + (1-beta)*IWAE."""
    return beta * vae_bound(log_w) + (1.0 - beta) * iwae_bound(log_w)


def power_bound(log_w: torch.Tensor, p: float) -> torch.Tensor:
    """L_power_p = mean_B[ (1/p) log mean_k exp(p log w) ]; p=1 -> IWAE."""
    return torch.mean(logmeanexp(p * log_w, dim=0) / p)


def median_bound(log_w: torch.Tensor) -> torch.Tensor:
    """mean_B[ median_k log w ], with JAX's median: for an even k the mean
    of the two middle values (``torch.median`` would take the lower one).
    The gradient flows through the middle order statistic(s) only."""
    k = log_w.shape[0]
    s = torch.sort(log_w, dim=0).values
    return torch.mean(0.5 * (s[(k - 1) // 2] + s[k // 2]))


def alpha_bound(log_w: torch.Tensor, log_px_given_h: torch.Tensor,
                alpha: float) -> torch.Tensor:
    """L_alpha = (1-alpha) E_q[log p(x|h)] + alpha L_VAE; `log_px_given_h`
    is the ``[k, B]`` reconstruction term of the same pass."""
    return (1.0 - alpha) * torch.mean(log_px_given_h) + alpha * vae_bound(log_w)


def vae_v1_bound(log_px_given_h: torch.Tensor, q_mu: torch.Tensor,
                 q_std: torch.Tensor) -> torch.Tensor:
    """Analytic-KL ELBO for a single stochastic layer:
    ``E_q[log p(x|h)] - mean_B sum_d KL(q(h|x) || N(0,1))``.

    Defined for single-stochastic-layer models only. A deeper encoder is
    detected, as in JAX, by the sample axis on ``q_mu`` (layer-1 parameters
    are ``[B, d]``, deeper layers' ``[k, B, d]``), or by no ``q_mu`` at all
    (``models.iwae.encode`` hands on none where ``L >= 2``), and rejected.
    """
    if q_mu is None or q_mu.dim() != 2:
        raise ValueError(
            "VAE_V1's analytic KL is defined for single-stochastic-layer "
            "models only; this encoder has L >= 2 -- use VAE (the MC "
            "estimator) instead")
    recon = torch.mean(log_px_given_h)
    kl = torch.mean(torch.sum(dist.normal_kl_standard(q_mu, q_std), dim=-1))
    return recon - kl


def bound_from_log_weights(spec: ObjectiveSpec, log_w: torch.Tensor,
                           aux: Optional[dict] = None) -> torch.Tensor:
    """Evaluate `spec`'s bound. `aux` (from ``models.log_weights_and_aux``)
    is required for L_alpha and VAE_V1 only."""
    name = spec.name
    if name == "VAE":
        return vae_bound(log_w)
    if name in ("IWAE", "PIWAE", "DReG", "STL"):
        return iwae_bound(log_w)
    if name == "MIWAE":
        return miwae_bound(log_w, spec.k2)
    if name == "CIWAE":
        return ciwae_bound(log_w, spec.beta)
    if name == "L_power_p":
        return power_bound(log_w, spec.p)
    if name == "L_median":
        return median_bound(log_w)
    if name == "L_alpha":
        if aux is None:
            raise ValueError("L_alpha needs aux['log_px_given_h']")
        return alpha_bound(log_w, aux["log_px_given_h"], spec.alpha)
    if name == "VAE_V1":
        if aux is None:
            raise ValueError("VAE_V1 needs aux['log_px_given_h'] and "
                             "aux['q_last']")
        q_mu, q_std = aux["q_last"] or (None, None)   # None: L >= 2
        return vae_v1_bound(aux["log_px_given_h"], q_mu, q_std)
    raise ValueError(f"unknown objective {name!r}")


def objective_bound(spec: ObjectiveSpec, params, cfg, x: torch.Tensor, *,
                    generator: Optional[torch.Generator] = None,
                    eps=None) -> torch.Tensor:
    """Convenience: one model pass + the bound."""
    from iwae_replication_project_tpu_torch.models import iwae as model

    log_w, aux = model.log_weights_and_aux(params, cfg, x, spec.k,
                                           generator=generator, eps=eps)
    return bound_from_log_weights(spec, log_w, aux)

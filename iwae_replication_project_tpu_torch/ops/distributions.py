"""Closed-form distribution numerics (port of ``ops/distributions.py``).

Only two log-densities are ever needed, so they are written out directly.
Reference-parity constants:

* std floor ``1e-6`` added to the exp-activated scale head;
* pixel-probability clamp ``p * (1 - 1e-6) + 1e-7``.

:func:`softplus` is spelled ``max(l, 0) + log1p(exp(-|l|))``, which is JAX's
``logaddexp(l, 0)``: ``torch.nn.functional.softplus`` switches to the
identity above ``threshold=20`` and so differs in the last bits.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

STD_FLOOR = 1e-6
PROB_CLAMP_SCALE = 1.0 - 1e-6
PROB_CLAMP_SHIFT = 1e-7

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` in the stable form JAX's ``jax.nn.softplus`` uses."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def normal_sample(mu: torch.Tensor, std: torch.Tensor,
                  sample_shape: tuple = (), *,
                  generator: Optional[torch.Generator] = None,
                  eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reparameterized draw ``mu + std * eps``; `sample_shape` is prepended.

    `eps` injects the standard-normal noise (tests replay the JAX package's
    draws through it); otherwise it is drawn from `generator`, whose device
    must match `mu`'s.
    """
    shape = tuple(sample_shape) + tuple(torch.broadcast_shapes(mu.shape,
                                                               std.shape))
    if eps is None:
        eps = torch.randn(shape, generator=generator, device=mu.device,
                          dtype=torch.result_type(mu, std))
    elif tuple(eps.shape) != shape:
        raise ValueError(f"injected noise has shape {tuple(eps.shape)}, "
                         f"expected {shape}")
    return mu + std * eps


def normal_log_prob(x: torch.Tensor, mu: torch.Tensor,
                    std: torch.Tensor) -> torch.Tensor:
    """Elementwise diagonal-Normal log density."""
    z = (x - mu) / std
    return -0.5 * z * z - torch.log(std) - _HALF_LOG_2PI


def standard_normal_log_prob(x: torch.Tensor) -> torch.Tensor:
    """log N(x; 0, 1), the top-of-chain prior."""
    return -0.5 * x * x - _HALF_LOG_2PI


def normal_kl_standard(mu: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """Closed-form KL(N(mu, std) || N(0, 1)), elementwise."""
    return -0.5 * (1.0 + 2.0 * torch.log(std) - mu * mu - std * std)


def clamp_probs(probs: torch.Tensor) -> torch.Tensor:
    """Reference pixel-probability clamp keeping Bernoulli log-probs finite."""
    return probs * PROB_CLAMP_SCALE + PROB_CLAMP_SHIFT


def bernoulli_log_prob(x: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """``x log p + (1-x) log(1-p)``; callers clamp `probs` first."""
    return x * torch.log(probs) + (1.0 - x) * torch.log1p(-probs)


def bernoulli_log_prob_from_logits(x: torch.Tensor,
                                   logits: torch.Tensor) -> torch.Tensor:
    """Numerically exact Bernoulli log pmf from logits: ``x*l - softplus(l)``."""
    return x * logits - softplus(logits)

"""Stable log-space reductions (port of ``ops/logsumexp.py``:20-31).

Only the dense reductions are ported; the online (streaming) carries serve
large-k evaluation and come with that slice.
"""

from __future__ import annotations

import math

import torch


def logsumexp(log_w: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Max-subtracted logsumexp along `dim`; an all ``-inf`` column gives
    ``-inf``, not NaN."""
    m = torch.amax(log_w, dim=dim, keepdim=True).detach()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return torch.log(torch.sum(torch.exp(log_w - m), dim=dim)) + m.squeeze(dim)


def logmeanexp(log_w: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``log mean exp`` along `dim`: the IWAE bound core."""
    return logsumexp(log_w, dim=dim) - math.log(float(log_w.shape[dim]))

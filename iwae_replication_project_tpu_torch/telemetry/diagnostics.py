"""Gradient signal-to-noise diagnostics of the training epoch (port of the
gradient-SNR part of ``telemetry/diagnostics.py``, :61-88 and :151-197).

SNR = |E[g]| / sigma[g] per parameter, from the first and second moments of
the gradients over the trailing ``snr_window`` optimizer steps of an epoch
(Rainforth et al.: the encoder's SNR decays as K grows). The moments stay on
the device; the summary is a dict of 0-d tensors the training loop fetches
with its per-stage fetch. The estimator diagnostics of evaluation (ESS,
log-weight variance, KL, active units) come with the evaluation slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from iwae_replication_project_tpu_torch.utils.tree import tree_leaves, tree_map

_SNR_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class DiagnosticsConfig:
    """The gradient-SNR knob; ``None`` in its place means diagnostics off.
    (The JAX config's ``enabled`` flag and active-units threshold come with
    the evaluation diagnostics.)"""

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


def grad_accum_update(acc: Tuple, grads, include: bool = True) -> Tuple:
    """Fold one step's grads in (in place) when `include`; the window mask
    is known on the host, so an excluded step costs nothing."""
    if include:
        s1, s2 = acc
        tree_map(lambda a, g: a.add_(g), s1, grads)
        tree_map(lambda a, g: a.addcmul_(g, g), s2, grads)
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

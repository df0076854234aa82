"""The numbers that decide ``correct``: gaps between what the program
produced and what the reference works out from the same inputs.

* :func:`loss_gap`: the largest relative gap of a step's loss;
* :func:`leaf_norm_gap`: by the worst leaf, the gap between the program's
  norm of a leaf and the reference's, over the reference's norm of that
  leaf or of the median leaf, whichever is larger (some gradients are all
  but zero);
* :func:`quiet_leaves`: leaves whose reference gradient is under a
  thousandth of the median leaf's, which Adam moves by round-off alone and
  the change leaves out;
* :func:`row_gap`: the largest gap of a row's estimate, in nats.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Sequence, Set

import torch


def loss_gap(program: Sequence[float], reference: Sequence[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.float())) for n, t in
            tensors.items()}


def quiet_leaves(ref_grads: Dict[str, torch.Tensor]) -> Set[str]:
    norms = _norms(ref_grads)
    med = statistics.median(norms.values())
    return {n for n, v in norms.items() if v < 1e-3 * med}


def leaf_norm_gap(program: Dict[str, torch.Tensor],
                  reference: Dict[str, torch.Tensor],
                  leave_out: Iterable[str] = ()) -> float:
    skip = set(leave_out)
    ref = {n: v for n, v in _norms(reference).items() if n not in skip}
    prog = _norms({n: program[n] for n in ref})
    med = statistics.median(ref.values())
    return max(abs(prog[n] - ref[n]) / max(ref[n], med) for n in ref)


def row_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    return float((program.float() - reference.float()).abs().max())

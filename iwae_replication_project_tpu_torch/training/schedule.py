"""The Burda 8-stage training schedule (port of ``training/schedule.py``,
copied: it is framework-free).

Stage i (1-based) runs ``3^(i-1)`` passes over the data at learning rate
``1e-4 * round(10^(1 - (i-1)/7), 1)`` — 1e-3 decaying to 1e-4, 3280 passes total.
"""

from __future__ import annotations

from typing import List, Tuple


def burda_stage_lr(stage: int) -> float:
    """Learning rate for 1-based `stage` (experiment_example.py:76)."""
    return 1e-4 * round(10.0 ** (1.0 - (stage - 1) / 7.0), 1)


def burda_stage_passes(stage: int, passes_scale: float = 1.0) -> int:
    """``max(1, round(3^(stage-1) * passes_scale))`` — the scale shrinks or
    stretches the schedule proportionally while keeping its geometric
    structure (small datasets overfit the 3280-pass MNIST schedule; see
    utils/config.py `passes_scale`)."""
    return max(1, int(round(3 ** (stage - 1) * passes_scale)))


def burda_stages(n_stages: int = 8, passes_scale: float = 1.0
                 ) -> List[Tuple[int, float, int]]:
    """``[(stage, lr, n_passes), ...]`` — sums to 3280 passes at n_stages=8,
    passes_scale=1 (657 at the digits protocol's 0.2)."""
    return [(i, burda_stage_lr(i), burda_stage_passes(i, passes_scale))
            for i in range(1, n_stages + 1)]

"""Chunk and batch sizing shared by the evaluation loops (the port's copy
of ``utils/flops.largest_divisor_leq``)."""

from __future__ import annotations


def largest_divisor_leq(n: int, cap: int) -> int:
    """Largest divisor of `n` not exceeding `cap`."""
    return max(d for d in range(1, min(cap, n) + 1) if n % d == 0)

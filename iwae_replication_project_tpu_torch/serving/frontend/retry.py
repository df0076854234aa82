"""RetryPolicy: the client half of the failure model (port of
``serving/frontend/retry.py``; framework-free, so a copy).

Every typed rejection of the tier ends in "retry with backoff"; this
module is where a caller does it. One frozen policy drives both
self-healing surfaces:

* :class:`~.client.TierClient` (``retry=``): blocking requests retry
  typed-retryable errors and reconnect across dropped or garbled
  connections, with optional tail-latency hedging;
* :class:`~.remote.RemoteEngine` (``retry=``): a poisoned proxy re-dials
  the child tier on the next submit, rate-limited by the same backoff, so
  a parent router's warm probes drive reconnection.

Semantics:

* **backoff** is exponential with decorrelated jitter,
  ``sleep = min(cap, uniform(base, prev_sleep * 3))``, from a
  ``random.Random`` seeded with ``(policy.seed, stream)``: the sequence of
  sleeps is a pure function of the seed, so a chaos run replays;
* **per-code retryability**: ``retry_codes`` names the typed codes worth
  retrying, by default all but ``bad_request``. Retrying a served but lost
  request is safe because results are a pure function of (weights,
  payload, seed, k): a caller that pins its seed gets the same answer on
  any attempt;
* **retry_after_s**: the policy sleeps ``max(backoff, hint)``. A
  ``quota_exceeded`` without a hint is the cost-above-burst rejection no
  wait can admit; the client raises it at once;
* **deadline**: one wall budget per logical request across all attempts
  and hedges;
* **hedging** (``hedge_after_s``): a blocking request unanswered after the
  delay is re-sent on a second connection with the same seed; the first
  response wins and the loser's connection is closed.
"""

from __future__ import annotations

import dataclasses
import random
from typing import FrozenSet, Optional

__all__ = ["RetryPolicy", "Backoff", "DEFAULT_RETRY_CODES"]

#: codes worth retrying (see the module docstring); never ``bad_request``
DEFAULT_RETRY_CODES: FrozenSet[str] = frozenset(
    {"overloaded", "quota_exceeded", "timeout", "unavailable", "internal"})


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Client retry and hedging knobs (frozen: share one across threads)."""

    max_attempts: int = 6
    base_delay_s: float = 0.02
    max_delay_s: float = 2.0
    #: overall wall budget per logical request (None = unbounded)
    deadline_s: Optional[float] = 30.0
    retry_codes: FrozenSet[str] = DEFAULT_RETRY_CODES
    #: also retry dropped or garbled connections (reconnecting first)
    retry_connection_errors: bool = True
    #: blocking-path tail-latency hedge delay (None = no hedging)
    hedge_after_s: Optional[float] = None
    #: seeds the jitter streams
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.base_delay_s < 0 or self.max_delay_s < self.base_delay_s:
            raise ValueError(
                f"need 0 <= base_delay_s <= max_delay_s, got "
                f"{self.base_delay_s} / {self.max_delay_s}")
        unknown = set(self.retry_codes) - set(DEFAULT_RETRY_CODES) - \
            {"bad_request"}
        if unknown:
            raise ValueError(f"unknown retry code(s): {sorted(unknown)}")

    def retryable(self, code: str) -> bool:
        return code in self.retry_codes

    def backoff(self, stream: int = 0) -> "Backoff":
        """A fresh deterministic delay stream for one logical request
        (`stream` decorrelates concurrent requests under one policy)."""
        return Backoff(self, random.Random(self.seed * 1_000_003 + stream))


class Backoff:
    """Decorrelated-jitter delays of one logical request:
    ``next_delay(hint)`` is how long to sleep before the next attempt, a
    server ``retry_after_s`` hint being its floor."""

    def __init__(self, policy: RetryPolicy, rng: random.Random):
        self._policy = policy
        self._rng = rng
        self._prev = policy.base_delay_s

    def next_delay(self, retry_after_s: Optional[float] = None) -> float:
        p = self._policy
        self._prev = min(p.max_delay_s,
                         self._rng.uniform(p.base_delay_s,
                                           max(p.base_delay_s,
                                               self._prev * 3.0)))
        return max(self._prev, retry_after_s or 0.0)

"""Per-(client, model) admission quotas: the token-bucket state machine
(port of ``serving/frontend/quotas.py``; framework-free, so a copy).

Each (client id, model) principal -- the request's ``client`` field
(absent: the shared ``"anonymous"`` principal) crossed with its ``model``
field (absent: the unlabeled default) -- owns one token bucket refilled at
``rate`` tokens a second up to ``burst``; admitting a request costs one
token per payload row. A dry bucket rejects with :class:`QuotaExceeded`,
which the front end turns into a typed ``quota_exceeded`` response, and a
rejection consumes nothing, so a throttled client recovers after exactly
``cost / rate`` seconds of restraint.

The quota layer sits above the router: client identity is an admission
concern only, and nothing client-derived reaches an engine. The clock is
injectable, so every transition (refill, burst clamp, reject) is testable
on a fake clock.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

#: the principal charged when a request carries no ``client`` field
DEFAULT_CLIENT = "anonymous"


class QuotaExceeded(RuntimeError):
    """The client's token bucket cannot cover the request; retry later.

    ``retry_after_s`` is the exact wait until the bucket covers the cost
    (None when no wait can help: a cost above the burst capacity).
    """

    def __init__(self, message: str, retry_after_s: Optional[float] = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


@dataclasses.dataclass(frozen=True)
class QuotaPolicy:
    """Token-bucket parameters shared by every principal: ``rate`` tokens a
    second, ``burst`` the capacity (also the largest admissible request, in
    rows). A new principal starts with a full bucket."""

    rate: float
    burst: float

    def __post_init__(self):
        if self.rate <= 0 or self.burst <= 0:
            raise ValueError(
                f"quota rate and burst must be > 0, got {self}")


class ClientQuotas:
    """Thread-safe per-principal token buckets under one policy;
    ``policy=None`` admits everything and keeps no state."""

    def __init__(self, policy: Optional[QuotaPolicy] = None,
                 clock: Callable[[], float] = time.monotonic):
        self._policy = policy
        self._clock = clock
        self._lock = threading.Lock()
        #: (client, model) -> [tokens, last_refill_time]; guarded by _lock
        self._buckets: Dict[tuple, List[float]] = {}

    @property
    def enabled(self) -> bool:
        return self._policy is not None

    @staticmethod
    def _principal(client: Optional[str],
                   model: Optional[str]) -> tuple:
        """The bucket key: model None is the unlabeled lane, distinct from
        every named model's."""
        return (client or DEFAULT_CLIENT, model)

    def _refilled(self, principal: tuple, now: float) -> List[float]:
        """The principal's bucket, refilled to `now` (caller holds _lock)."""
        p = self._policy
        b = self._buckets.get(principal)
        if b is None:
            b = self._buckets.setdefault(principal, [p.burst, now])
        else:
            b[0] = min(p.burst, b[0] + (now - b[1]) * p.rate)
            b[1] = now
        return b

    def admit(self, client: Optional[str], cost: float,
              model: Optional[str] = None) -> None:
        """Charge `cost` tokens to the (client, model) principal or raise
        :class:`QuotaExceeded` (consuming nothing). A cost above ``burst``
        can never be admitted and says so: the request must be split."""
        if self._policy is None:
            return
        principal = self._principal(client, model)
        if cost > self._policy.burst:
            raise QuotaExceeded(
                f"request cost {cost:g} rows exceeds the per-client burst "
                f"capacity {self._policy.burst:g} — split the request")
        with self._lock:
            b = self._refilled(principal, self._clock())
            if b[0] < cost:
                wait = (cost - b[0]) / self._policy.rate
                lane = f" (model {model!r})" if model is not None else ""
                raise QuotaExceeded(
                    f"client {principal[0]!r}{lane} quota exhausted "
                    f"({b[0]:.2f}/{self._policy.burst:g} tokens, cost "
                    f"{cost:g}); retry in ~{wait:.2f}s",
                    retry_after_s=wait)
            b[0] -= cost

    def refund(self, client: Optional[str], cost: float,
               model: Optional[str] = None) -> None:
        """Return `cost` tokens (clamped at burst): the undo of an
        :meth:`admit` whose request routing then rejected, so the quota
        meters served work only."""
        if self._policy is None:
            return
        with self._lock:
            b = self._refilled(self._principal(client, model), self._clock())
            b[0] = min(self._policy.burst, b[0] + cost)

    def tokens(self, client: Optional[str],
               model: Optional[str] = None) -> Optional[float]:
        """The principal's refilled balance (None when quotas are off)."""
        if self._policy is None:
            return None
        with self._lock:
            return self._refilled(self._principal(client, model),
                                  self._clock())[0]

    def clients(self) -> List[str]:
        """Distinct client ids with live buckets (any model lane)."""
        with self._lock:
            return sorted({c for c, _m in self._buckets})

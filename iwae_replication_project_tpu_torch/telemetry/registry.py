"""The metric registry: counters, gauges and histograms.

A framework-free copy of the JAX package's ``telemetry/registry.py`` (the port
imports nothing from that package). Named instruments, created on first
touch, thread-safe, exportable as a nested snapshot.

Design points:

* **log-spaced histograms**, not reservoirs: O(1) per record, every event
  accounted at any volume, and a quantile readout within one bin width
  (~33% at 8 bins/decade) of truth — the serving engine's shedding policy
  and the span tracer both want a cheap always-on gauge, not a sample;
* **get-or-create by name**: call sites never hold instrument handles across
  module boundaries, so exporters see every metric without wiring;
* a **process-default registry** (:func:`get_registry`) for cross-cutting
  instruments (spans, training-loop diagnostics); subsystems that need isolation
  (one :class:`~..serving.metrics.ServingMetrics` per engine, tests) build
  their own instance — same types.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Union

#: default histogram geometry: 8 bins per decade from 1e-6 to 1e3 (+overflow)
#: — for seconds this spans 1 us .. 1000 s, the whole latency range the
#: framework observes, at ~33% quantile resolution
BINS_PER_DECADE = 8
HIST_LO = 1e-6
HIST_DECADES = 9


class Counter:
    """Monotonic counter (int-preserving until a float is added)."""

    __slots__ = ("_lock", "_v")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._v: Union[int, float] = 0

    def inc(self, n: Union[int, float] = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> Union[int, float]:
        # scrape-side reads hold the same lock the writers hold
        with self._lock:
            return self._v


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("_lock", "_v")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._v: float = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v

    @property
    def value(self) -> float:
        with self._lock:  # lock-consistent read; see Counter.value
            return self._v


class Histogram:
    """Log-spaced-bin histogram with percentile readout.

    `lo` is the lower edge of the first bin; values at or below it land in
    bin 0, values past the top decade in the overflow bin. ``percentile``
    returns the *upper bound* of the bin holding the q-quantile — an upper
    estimate within one bin width of truth.
    """

    __slots__ = ("_lock", "lo", "bins_per_decade", "counts", "n", "total",
                 "vmax")

    def __init__(self, lock: Optional[threading.Lock] = None,
                 lo: float = HIST_LO, bins_per_decade: int = BINS_PER_DECADE,
                 decades: int = HIST_DECADES):
        self._lock = lock or threading.Lock()
        self.lo = lo
        self.bins_per_decade = bins_per_decade
        self.counts: List[int] = [0] * (bins_per_decade * decades + 1)
        self.n = 0
        self.total = 0.0
        self.vmax = 0.0  # exact observed max: clamps the percentile upper
        #                  bounds (a quantile can never exceed the max, and
        #                  the overflow bin's nominal bound is meaningless)

    def _bin_index(self, v: float) -> int:
        if v <= self.lo:
            return 0
        i = int(math.log10(v / self.lo) * self.bins_per_decade)
        return min(i, len(self.counts) - 1)

    def _bin_upper(self, i: int) -> float:
        return self.lo * 10.0 ** ((i + 1) / self.bins_per_decade)

    def record(self, v: float) -> None:
        with self._lock:
            i = self._bin_index(v)
            self.counts[i] += 1
            self.n += 1
            self.total += v
            if v > self.vmax:
                self.vmax = v

    def percentile(self, q: float) -> Optional[float]:
        """Upper bound of the bin holding the q-quantile (q in [0, 1]),
        clamped by the exact observed max."""
        with self._lock:
            return self._percentile(q)

    def _percentile(self, q: float) -> Optional[float]:
        # caller holds self._lock: counts/n/vmax are read as one consistent
        # state (the writers mutate them together under the same lock)
        if self.n == 0:
            return None
        target = q * self.n
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return min(self._bin_upper(i), self.vmax)
        return self.vmax

    def summary(self) -> Dict[str, Optional[float]]:
        with self._lock:  # one consistent view across count/mean/percentiles
            mean = self.total / self.n if self.n else None
            return {"count": self.n, "mean": mean,
                    # the exact running sum: exporters emit it verbatim as
                    # the Prometheus `_sum` instead of reconstructing
                    # mean * count (which re-rounds what we already track)
                    "total": self.total if self.n else None,
                    "p50": self._percentile(0.50),
                    "p95": self._percentile(0.95),
                    "p99": self._percentile(0.99),
                    "max": self.vmax if self.n else None}


class MetricRegistry:
    """Named instruments, created on first touch; one lock per registry.

    Names are slash-separated paths (``"latency/score/b4"``,
    ``"span/train/stage"``); exporters keep them verbatim (JSONL/TB) or
    sanitize them (Prometheus).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def _get_or_create(self, store: dict, name: str, make):
        inst = store.get(name)
        if inst is None:
            with self._lock:
                inst = store.get(name)
                if inst is None:
                    for other in (self._counters, self._gauges,
                                  self._histograms):
                        if other is not store and name in other:
                            raise ValueError(
                                f"metric {name!r} already registered as a "
                                f"different instrument type")
                    inst = store[name] = make()
        return inst

    def counter(self, name: str) -> Counter:
        return self._get_or_create(self._counters, name,
                                   lambda: Counter(self._lock))

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(self._gauges, name,
                                   lambda: Gauge(self._lock))

    def histogram(self, name: str, factory=None) -> Histogram:
        """`factory` customizes the histogram class/geometry on FIRST touch
        (later calls return the existing instrument unchanged)."""
        make = (lambda: factory(self._lock)) if factory is not None \
            else (lambda: Histogram(self._lock))
        return self._get_or_create(self._histograms, name, make)

    # -- export ------------------------------------------------------------

    def snapshot(self) -> dict:
        """Nested document: counter/gauge values + histogram summaries."""
        with self._lock:
            counters = {k: c._v for k, c in self._counters.items()}
            gauges = {k: g._v for k, g in self._gauges.items()}
            hists = list(self._histograms.items())
        return {"counters": counters, "gauges": gauges,
                "histograms": {k: h.summary() for k, h in sorted(hists)}}

    def rows(self, prefix: str = "") -> Dict[str, float]:
        """Flat ``name -> float`` rows for ``utils.logging.MetricsLogger``:
        counters and gauges verbatim, histograms as ``<name>/<stat>``."""
        snap = self.snapshot()
        out: Dict[str, float] = {}
        for k, v in snap["counters"].items():
            out[prefix + k] = float(v)
        for k, v in snap["gauges"].items():
            out[prefix + k] = float(v)
        for name, summary in snap["histograms"].items():
            for stat, v in summary.items():
                if v is not None:
                    out[f"{prefix}{name}/{stat}"] = float(v)
        return out


#: the process-default registry: spans, training-loop diagnostics, and anything
#: cross-cutting report here; subsystem-scoped registries are built per owner
_DEFAULT = MetricRegistry()


def get_registry() -> MetricRegistry:
    return _DEFAULT

"""Service-level objectives: per-(model, op) burn-rate gauges (port of
``telemetry/slo.py``, on the port's ``telemetry/registry``).

An autoscaler needs one signal above raw latency histograms: how fast is
each (model, op) burning its error budget? This module declares latency
and availability objectives and publishes multi-window burn rates as
ordinary registry gauges; the serving tier's ``slo`` control op returns
the same numbers as one JSON document.

Definitions (the standard SRE accounting):

* a request is a **latency violation** when it errored or took longer than
  the objective's ``latency_s`` (an errored request is not a fast good
  response);
* a request is an **availability violation** when its typed error code is
  server-attributable (``DEFAULT_ERROR_CODES``: internal / timeout /
  unavailable / overloaded).  ``bad_request`` and ``quota_exceeded`` are
  the client's doing and never burn the server's budget (the front end
  does not even observe ``bad_request`` traffic — a garbage op name must
  not mint gauges);
* **burn rate** over a window = observed violation fraction ÷ allowed
  violation fraction (``1 - target``).  1.0 means the budget burns exactly
  as fast as it refills; a fast-window burn ≫ 1 with the slow window
  confirming is the page/scale-up signal.

Windows are bucketed rings (``buckets`` slots per window, advanced by the
injectable clock), so ``observe`` is O(1) amortized and the gauges read
the trailing window, not process-lifetime averages.

Published instruments, per key (``<model>/<op>``, or ``<op>`` for the
unlabeled single-model tier):

* gauges ``slo/<key>/latency_burn_<win>`` and
  ``slo/<key>/availability_burn_<win>`` for every window (default ``5m``
  and ``1h``);
* counters ``slo/<key>/requests``, ``slo/<key>/latency_violations``,
  ``slo/<key>/errors``; plus the unkeyed ``slo/clock_regressions``
  (injected-clock steps backwards are clamped to the high-water mark and
  counted — windows never rewind and burns never go negative).

The schema is the JAX package's (tests/test_telemetry.py pins it there).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

from iwae_replication_project_tpu_torch.telemetry.registry import MetricRegistry

__all__ = ["SLOObjective", "SLOMonitor", "DEFAULT_ERROR_CODES",
           "DEFAULT_WINDOWS", "peak_burns", "window_requests"]

#: typed protocol codes that count against the availability objective —
#: the server-attributable half of protocol.ERROR_CODES
DEFAULT_ERROR_CODES = frozenset(
    {"internal", "timeout", "unavailable", "overloaded"})

#: (window seconds, gauge label): the classic fast/slow multi-window pair
DEFAULT_WINDOWS: Tuple[Tuple[float, str], ...] = ((300.0, "5m"),
                                                  (3600.0, "1h"))


@dataclasses.dataclass(frozen=True)
class SLOObjective:
    """One (model, op)'s objectives (frozen: share across threads).

    ``latency_s`` is the per-request threshold, ``latency_target`` the
    fraction of requests that must beat it, ``availability_target`` the
    fraction that must not error."""

    latency_s: float = 0.5
    latency_target: float = 0.99
    availability_target: float = 0.999

    def __post_init__(self):
        if self.latency_s <= 0:
            raise ValueError(f"latency_s must be > 0, got {self.latency_s}")
        for name in ("latency_target", "availability_target"):
            v = getattr(self, name)
            if not 0.0 < v < 1.0:
                raise ValueError(f"{name} must be in (0, 1), got {v} — a "
                                 f"target of 1.0 makes every burn rate "
                                 f"infinite")


class _Ring:
    """One bucketed sliding window of (total, latency-bad, error-bad)
    counts.  No lock of its own: the owning monitor's lock guards it."""

    __slots__ = ("width_s", "total", "bad_lat", "bad_err", "epoch")

    def __init__(self, window_s: float, buckets: int):
        self.width_s = window_s / buckets
        self.total = [0] * buckets
        self.bad_lat = [0] * buckets
        self.bad_err = [0] * buckets
        self.epoch: Optional[int] = None   # absolute index of current slot

    def _advance(self, now: float) -> None:
        e = int(now / self.width_s)
        n = len(self.total)
        if self.epoch is None:
            self.epoch = e
            return
        # step clamped to [0, n]: a backwards clock (already clamped by the
        # monitor, but this ring must be safe standalone) must not clear
        # slots or move the epoch back — time only advances here
        step = min(max(e - self.epoch, 0), n)
        for j in range(1, step + 1):
            i = (self.epoch + j) % n
            self.total[i] = self.bad_lat[i] = self.bad_err[i] = 0
        if e > self.epoch:
            self.epoch = e

    def observe(self, now: float, lat_bad: bool, err_bad: bool) -> None:
        self._advance(now)
        i = self.epoch % len(self.total)
        self.total[i] += 1
        self.bad_lat[i] += lat_bad
        self.bad_err[i] += err_bad

    def fractions(self, now: float) -> Tuple[float, float, int]:
        self._advance(now)
        t = sum(self.total)
        if not t:
            return 0.0, 0.0, 0
        return sum(self.bad_lat) / t, sum(self.bad_err) / t, t


class SLOMonitor:
    """Observe request outcomes; publish burn-rate gauges per (model, op).

    ``objectives`` maps ``(model, op)`` (model ``None`` = the unlabeled
    lane) to :class:`SLOObjective`; anything unlisted uses ``default``.
    ``registry`` is where the gauges/counters land — the serving tier
    passes its router registry so the burn rates sit beside the router's
    counters.  The clock is injectable (tests drive window
    rotation with a fake clock, like quotas and the batcher)."""

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 default: SLOObjective = SLOObjective(),
                 objectives: Optional[Dict[Tuple[Optional[str], str],
                                           SLOObjective]] = None,
                 windows: Sequence[Tuple[float, str]] = DEFAULT_WINDOWS,
                 buckets_per_window: int = 30,
                 error_codes: frozenset = DEFAULT_ERROR_CODES,
                 clock: Callable[[], float] = time.monotonic):
        if not windows:
            raise ValueError("at least one burn-rate window is required")
        self.registry = registry if registry is not None else MetricRegistry()
        self.default = default
        self.objectives = dict(objectives) if objectives else {}
        self.windows = tuple((float(w), str(label)) for w, label in windows)
        self.error_codes = frozenset(error_codes)
        self._buckets = int(buckets_per_window)
        self._clock = clock
        self._lock = threading.Lock()
        #: key -> [one _Ring per window]; guarded by _lock
        self._rings: Dict[str, list] = {}
        #: high-water clock mark, guarded by _lock — see _now_clamped
        self._last_now: Optional[float] = None

    def _now_clamped(self) -> Tuple[float, bool]:
        """Read the clock, clamped to its own high-water mark.

        An injectable clock is not guaranteed monotonic (a wall-clock
        passed by mistake, NTP step, or a test fixture rewinding): feeding
        a backwards ``now`` into the rings would either resurrect stale
        slots or mint negative burn windows.  Policy per the observability
        plan: CLAMP to the last seen time and COUNT the regression —
        never crash, never go back.  Caller must hold ``_lock``."""
        now = self._clock()
        regressed = self._last_now is not None and now < self._last_now
        if regressed:
            now = self._last_now
        else:
            self._last_now = now
        return now, regressed

    @staticmethod
    def key_for(model: Optional[str], op: str) -> str:
        """The gauge-name key (mirrors ServingMetrics' histogram keys)."""
        return f"{model}/{op}" if model else op

    def objective_for(self, model: Optional[str], op: str) -> SLOObjective:
        obj = self.objectives.get((model, op))
        if obj is None and model is not None:
            obj = self.objectives.get((None, op))   # op-wide fallback
        return obj if obj is not None else self.default

    def observe(self, op: str, latency_s: float, *,
                model: Optional[str] = None,
                error_code: Optional[str] = None) -> None:
        """Account one finished request and republish its key's gauges."""
        obj = self.objective_for(model, op)
        err_bad = error_code is not None and error_code in self.error_codes
        lat_bad = err_bad or latency_s > obj.latency_s
        key = self.key_for(model, op)
        with self._lock:
            now, regressed = self._now_clamped()
            rings = self._rings.get(key)
            if rings is None:
                rings = self._rings[key] = [
                    _Ring(w, self._buckets) for w, _ in self.windows]
            fracs = []
            for ring in rings:
                ring.observe(now, lat_bad, err_bad)
                fracs.append(ring.fractions(now))
        # publish OUTSIDE the monitor lock: the registry has its own lock
        # and the lock graph stays a tree by construction
        if regressed:
            self.registry.counter("slo/clock_regressions").inc()
        for (_, label), (lat_frac, err_frac, _n) in zip(self.windows, fracs):
            self.registry.gauge(f"slo/{key}/latency_burn_{label}").set(
                lat_frac / (1.0 - obj.latency_target))
            self.registry.gauge(f"slo/{key}/availability_burn_{label}").set(
                err_frac / (1.0 - obj.availability_target))
        self.registry.counter(f"slo/{key}/requests").inc()
        if lat_bad:
            self.registry.counter(f"slo/{key}/latency_violations").inc()
        if err_bad:
            self.registry.counter(f"slo/{key}/errors").inc()

    def snapshot(self) -> Dict[str, dict]:
        """Current burn rates per key (the wire-facing document;
        the JAX package's schema)."""
        with self._lock:
            now, _ = self._now_clamped()
            keys = {key: [r.fractions(now) for r in rings]
                    for key, rings in self._rings.items()}
        out: Dict[str, dict] = {}
        for key, fracs in keys.items():
            model, _, op = key.rpartition("/")
            obj = self.objective_for(model or None, op or key)
            wins = {}
            for (_, label), (lat_frac, err_frac, n) in zip(self.windows,
                                                           fracs):
                wins[label] = {
                    "requests": n,
                    "latency_burn": lat_frac / (1.0 - obj.latency_target),
                    "availability_burn":
                        err_frac / (1.0 - obj.availability_target),
                }
            out[key] = {
                "objective": dataclasses.asdict(obj),
                "windows": wins,
            }
        return out


# -- snapshot reductions (the autoscaler's scalar signals) -------------------
#
# Pure functions over the snapshot() document — NOT monitor methods — so the
# fleet controller applies the identical reduction to a local monitor's
# snapshot and to one shipped over the wire by the `slo` control op (a
# fleet-of-fleets parent scales children it only sees as JSON).

def peak_burns(snapshot: Dict[str, dict]) -> Dict[str, float]:
    """Worst burn rate per window label across every (model, op) key and
    both objectives (latency and availability).

    One scalar per window is what the scaling decision consumes: the fleet
    must grow when ANY class burns its budget — averaging across keys would
    let a small hot tenant drown under a large cold one. Empty snapshot
    (no traffic yet) reads as 0.0 burns for no windows; callers treat a
    missing label as burn 0."""
    out: Dict[str, float] = {}
    for doc in snapshot.values():
        for label, win in doc.get("windows", {}).items():
            burn = max(float(win.get("latency_burn", 0.0)),
                       float(win.get("availability_burn", 0.0)))
            out[label] = max(out.get(label, 0.0), burn)
    return out


def window_requests(snapshot: Dict[str, dict]) -> Dict[str, int]:
    """Total requests per window label summed across keys — the idleness
    half of the scaling signal (a fleet with zero trailing-window traffic
    and no burn is a scale-down candidate)."""
    out: Dict[str, int] = {}
    for doc in snapshot.values():
        for label, win in doc.get("windows", {}).items():
            out[label] = out.get(label, 0) + int(win.get("requests", 0))
    return out

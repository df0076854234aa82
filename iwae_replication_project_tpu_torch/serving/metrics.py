"""Serving observability: engine counters, per-(op, bucket) latency
histograms and hot-loop kernel stamps (port of ``serving/metrics.py``,
without the JAX executable-store section).

Histogram keys: ``latency/<op>/b<bucket>`` (total observed latency),
``queue_wait/...`` (submit -> launch) and ``device_wait/...`` (launch ->
fetched), tenant-labelled ``<model>[@<precision>]/<op>/b<bucket>`` when the
engine serves a named model or a precision policy.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from iwae_replication_project_tpu_torch.telemetry.registry import (
    Histogram,
    MetricRegistry,
)

_LAT = "latency/"
_QW = "queue_wait/"
_DW = "device_wait/"


class LatencyHistogram(Histogram):
    """Seconds-unit view of the registry histogram (8 bins/decade, 1 us ..
    1000 s); summary keys carry the ``_s`` suffix."""

    def summary(self) -> Dict[str, Optional[float]]:
        s = super().summary()
        return {"count": s["count"], "mean_s": s["mean"],
                "total_s": s["total"], "p50_s": s["p50"],
                "p95_s": s["p95"], "p99_s": s["p99"]}


class ServingMetrics:
    """Thread-safe engine counters + per-(op, bucket) latency histograms +
    per-(op, bucket, program k) hot-loop path stamps."""

    COUNTERS = ("submitted", "completed", "timeouts", "shed", "errors",
                "dispatches", "real_rows", "padded_rows",
                "aot_hits", "aot_misses", "recompiles")

    def __init__(self, model: Optional[str] = None,
                 precision: Optional[str] = None):
        self.registry = MetricRegistry()
        self.model = model
        self.precision = precision
        for name in self.COUNTERS:
            self.registry.counter(name)
        self._queue_depth = self.registry.gauge("queue_depth")
        self._inflight = self.registry.gauge("inflight")
        # per-(op, bucket, k) path stamps: the code rides a gauge, the path
        # name this dict (written by the dispatcher, read by snapshots)
        self._kernel_lock = threading.Lock()
        self._kernel: Dict[str, dict] = {}

    def count(self, name: str, n: float = 1) -> None:
        self.registry.counter(name).inc(n)

    def counters(self) -> Dict[str, float]:
        snap = self.registry.snapshot()
        return {k: snap["counters"].get(k, 0) for k in self.COUNTERS}

    def set_queue_depth(self, depth: int) -> None:
        self._queue_depth.set(int(depth))

    def set_inflight(self, n: int) -> None:
        """Batches between launch and completion (the pipelined window's
        occupancy; 0 when idle or serial)."""
        self._inflight.set(int(n))

    @property
    def inflight(self) -> int:
        return int(self._inflight.value)

    def set_kernel(self, op: str, k, bucket: int, path_code: int,
                   path: str) -> None:
        """Stamp the hot-loop path of one (op, k, bucket) dispatch config on
        a ``kernel/<op>/b<bucket>/k<k>[/<precision>]`` gauge. `k` is the
        program's k: the request's for static-k programs, ``"dyn"`` for the
        sharded engine's, whose one program per bucket serves every k (a
        ragged k stream adds no gauge per k)."""
        key = f"{op}/b{bucket}/k{k}"
        if self.precision:
            key = f"{key}/{self.precision}"
        self.registry.gauge(f"kernel/{key}").set(float(path_code))
        with self._kernel_lock:
            rec = {"path_code": int(path_code), "path": str(path)}
            if self.precision:
                rec["precision"] = str(self.precision)
            self._kernel[key] = rec

    def _hist_key(self, op: str, bucket: int) -> str:
        label = f"{self.model or 'default'}@{self.precision}" \
            if self.precision else self.model
        return f"{label}/{op}/b{bucket}" if label else f"{op}/b{bucket}"

    def record_latency(self, op: str, bucket: int, seconds: float) -> None:
        self.registry.histogram(f"{_LAT}{self._hist_key(op, bucket)}",
                                factory=LatencyHistogram).record(seconds)

    def record_queue_wait(self, op: str, bucket: int, seconds: float) -> None:
        self.registry.histogram(f"{_QW}{self._hist_key(op, bucket)}",
                                factory=LatencyHistogram).record(seconds)

    def record_device_wait(self, op: str, bucket: int,
                           seconds: float) -> None:
        self.registry.histogram(f"{_DW}{self._hist_key(op, bucket)}",
                                factory=LatencyHistogram).record(seconds)

    def snapshot(self) -> dict:
        """Counters, padding waste, kernel stamps and per-bucket latency
        summaries (total plus the queue/device split)."""
        snap = self.registry.snapshot()
        c = {k: snap["counters"].get(k, 0) for k in self.COUNTERS}
        rows = c["real_rows"] + c["padded_rows"]

        def section(prefix):
            return {name[len(prefix):]: s
                    for name, s in snap["histograms"].items()
                    if name.startswith(prefix)}

        with self._kernel_lock:
            kernel = {key: dict(rec) for key, rec in self._kernel.items()}
        doc = {
            "model": self.model,
            "counters": c,
            "queue_depth": int(snap["gauges"].get("queue_depth", 0)),
            "inflight": int(snap["gauges"].get("inflight", 0)),
            "kernel_path": int(snap["gauges"].get("kernel_path", 0)),
            "kernel": kernel,
            "padding_waste": (c["padded_rows"] / rows) if rows else 0.0,
            "latency": section(_LAT),
            "queue_wait": section(_QW),
            "device_wait": section(_DW),
        }
        if self.precision:
            doc["precision"] = self.precision
        return doc

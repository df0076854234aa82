"""Continuous profiling plane: per-dispatch device-time attribution (port
of ``telemetry/profiling.py``).

:class:`DispatchProfiler` stamps the measured device interval of every
dispatched batch per ``(model, program, bucket, k-class)`` into ``prof/*``
instruments and derives live measured MFU and bandwidth gauges against the
card's peak table (``utils/flops.py``) and each program's static cost record
(``serving/programs.static_cost``, the counterpart of the JAX store's
trace-time record). The bookkeeping is the JAX module's, line for line: the
same key format, EWMA/z rule, instruments and snapshot schema.

Three layers, all host-side metadata (profiling never touches seeds,
payloads or programs: results are bitwise the same on and off, and the off
mode records nothing):

* **attribution** -- ``prof/device_s/<key>`` histograms plus the
  ``prof/dispatches`` / ``prof/rows`` counters;
* **measured-vs-static gauges** -- ``prof/mfu/<key>`` (matmul FLOP/s over
  the card's bf16 peak), ``prof/hbm_frac/<key>`` (the record's unavoidable
  bytes per second over the peak HBM bandwidth) and
  ``prof/ceiling_ratio/<key>`` (measured seconds over the roofline floor);
* **drift detection** -- a per-key EWMA baseline of the device interval;
  once armed (``warmup_samples``), a sample above its baseline by
  ``z_threshold`` sigmas emits one typed ``prof/drift`` finding, counts
  ``prof/drift`` and publishes ``prof/z/<key>``.

The serving engines attach one per engine (serving/engine.py
``profiling=``, on by default). On the card the interval is the time
between two CUDA timing events around the program's call on the engine's
stream; on the CPU it is the host interval, as in JAX. The snapshot is
served at ``/prof`` by the metrics server (telemetry/exporters.py).
"""

from __future__ import annotations

import dataclasses
import math
import threading
from collections import deque
from typing import Dict, List, Optional

from iwae_replication_project_tpu_torch.telemetry.registry import (
    MetricRegistry,
)

__all__ = ["ProfilingConfig", "DispatchProfiler", "DriftFinding",
           "detect_chip_peaks"]


def detect_chip_peaks(device=None) -> Dict[str, Optional[float]]:
    """``{"peak_flops", "peak_hbm_bytes", "source"}`` of the card (`device`,
    default the current one).

    A card resolves through the card rows of ``utils/flops.py``
    (``torch.cuda.get_device_name``); an unknown card, or no card, yields
    None peaks with the reason, so the MFU and bandwidth gauges are not
    published, while device-time attribution and drift detection run
    everywhere. Fail-soft: engines call it at construction, and a probe
    failure must degrade to "no peaks", not kill serving.
    """
    try:
        import torch

        from iwae_replication_project_tpu_torch.utils.flops import (
            peak_flops_for_card,
            peak_hbm_bytes_for_card,
        )
        dev = torch.device(device) if device is not None else None
        if (dev is not None and dev.type != "cuda") or \
                not torch.cuda.is_available():
            platform = dev.type if dev is not None else "cpu"
            return {"peak_flops": None, "peak_hbm_bytes": None,
                    "source": f"no peak table for platform {platform!r} "
                              f"(no CUDA device)"}
        name = torch.cuda.get_device_name(dev)
        flops, f_src = peak_flops_for_card(name)
        hbm, _ = peak_hbm_bytes_for_card(name)
        return {"peak_flops": flops, "peak_hbm_bytes": hbm, "source": f_src}
    except Exception as e:  # pragma: no cover - backend-dependent
        return {"peak_flops": None, "peak_hbm_bytes": None,
                "source": f"chip detection failed: {e}"}


@dataclasses.dataclass(frozen=True)
class ProfilingConfig:
    """Knobs of one engine's profiler (frozen: share across threads).

    ``ewma_alpha`` weights the exponential baseline (higher = faster
    adaptation, shorter memory); ``z_threshold`` is the drift alarm bound
    in baseline sigmas; ``warmup_samples`` arms the detector only after
    the baseline has seen that many intervals per key (a cold program's
    first dispatches are not drift); ``min_sigma_frac`` floors the
    baseline sigma at that fraction of the EWMA mean, so a near-constant
    baseline does not page on measurement jitter. ``peak_flops`` /
    ``peak_hbm_bytes`` override chip detection (how CPU tests exercise the
    MFU gauges); None = detect."""

    enabled: bool = True
    ewma_alpha: float = 0.2
    z_threshold: float = 6.0
    warmup_samples: int = 8
    min_sigma_frac: float = 0.05
    max_findings: int = 256
    peak_flops: Optional[float] = None
    peak_hbm_bytes: Optional[float] = None

    def __post_init__(self):
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got "
                             f"{self.ewma_alpha}")
        if self.z_threshold <= 0:
            raise ValueError(f"z_threshold must be > 0, got "
                             f"{self.z_threshold}")
        if self.warmup_samples < 2:
            raise ValueError(f"warmup_samples must be >= 2, got "
                             f"{self.warmup_samples} — a baseline with "
                             f"fewer samples has no variance to test "
                             f"against")


@dataclasses.dataclass(frozen=True)
class DriftFinding:
    """One typed ``prof/drift`` finding: a warm program's device interval
    departed its own EWMA baseline by ``z`` sigmas (schema pinned in
    tests/test_torch_observability.py; ``to_dict`` is the wire/CLI form)."""

    kind: str
    key: str
    program: str
    model: Optional[str]
    bucket: int
    k_class: str
    measured_s: float
    baseline_s: float
    sigma_s: float
    z: float
    ratio: float
    seq: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class _KeyState:
    """Per-attribution-key EWMA baseline (owner's lock guards it)."""

    __slots__ = ("count", "ewma", "ewvar", "last_s", "last_mfu",
                 "last_hbm_frac", "last_ceiling_ratio", "last_z",
                 "ewma_k_used", "last_k_used")

    def __init__(self):
        self.count = 0
        self.ewma = 0.0
        self.ewvar = 0.0
        self.last_s = 0.0
        self.last_mfu: Optional[float] = None
        self.last_hbm_frac: Optional[float] = None
        self.last_ceiling_ratio: Optional[float] = None
        self.last_z: Optional[float] = None
        #: per-row sample-count attribution (adaptive-k dispatches only;
        #: None = this key never reported samples — fixed-k traffic)
        self.ewma_k_used: Optional[float] = None
        self.last_k_used: Optional[float] = None


class DispatchProfiler:
    """Per-dispatch device-time attributor + drift detector (module doc).

    ``registry`` is where the ``prof/*`` instruments land — the serving
    engine passes its own metrics registry so the profiling plane rides
    the same Prometheus page as the latency split.  ``label`` names the
    tenant (the engine's ``store_label`` composite, e.g.
    ``mnist@bf16``); None keeps unlabeled keys.  Thread-safe: ``observe``
    runs on the completion thread, snapshots/scrapes on any other; the
    profiler's lock is a leaf (registry publication happens OUTSIDE it,
    the SLOMonitor discipline — the lock graph stays a tree)."""

    def __init__(self, registry: Optional[MetricRegistry] = None,
                 config: Optional[ProfilingConfig] = None,
                 label: Optional[str] = None,
                 peaks: Optional[Dict[str, Optional[float]]] = None):
        self.registry = registry if registry is not None else MetricRegistry()
        self.config = config if config is not None else ProfilingConfig()
        self.label = label
        if peaks is None:
            peaks = detect_chip_peaks()
        if self.config.peak_flops is not None:
            peaks = dict(peaks)
            peaks["peak_flops"] = float(self.config.peak_flops)
            peaks["source"] = "explicit ProfilingConfig.peak_flops override"
        if self.config.peak_hbm_bytes is not None:
            peaks = dict(peaks)
            peaks["peak_hbm_bytes"] = float(self.config.peak_hbm_bytes)
        self.peaks = peaks
        self._lock = threading.Lock()
        #: key -> _KeyState; guarded by _lock
        self._keys: Dict[str, _KeyState] = {}
        #: bounded typed prof/drift finding ring; guarded by _lock
        self._findings: deque = deque(maxlen=int(self.config.max_findings))
        self._seq = 0
        self._dropped_findings = 0

    def _key(self, program: str, bucket: int, k_class) -> str:
        base = f"{program}/b{bucket}/k{k_class}"
        return f"{self.label}/{base}" if self.label else base

    @staticmethod
    def static_floor_s(cost: Optional[dict],
                       peaks: Dict[str, Optional[float]]) -> Optional[float]:
        """The roofline floor: the static cost record's compute and
        traffic legs each at chip peak, whichever binds — the seconds the
        hardware *cannot* beat for this program.  None when the record or
        both peaks are missing (the ceiling-ratio gauge is then not
        published rather than divided by a guess)."""
        if not cost:
            return None
        floor = 0.0
        pf, pb = peaks.get("peak_flops"), peaks.get("peak_hbm_bytes")
        if pf and cost.get("flops"):
            floor = max(floor, float(cost["flops"]) / pf)
        if pb and cost.get("bytes_accessed_fused"):
            floor = max(floor, float(cost["bytes_accessed_fused"]) / pb)
        return floor or None

    def observe(self, *, program: str, bucket: int, k_class,
                rows: int, device_s: float,
                flops: Optional[float] = None,
                cost: Optional[dict] = None,
                samples: Optional[float] = None) -> Optional[DriftFinding]:
        """Account one completed dispatch; returns the drift finding when
        this sample tripped the detector (else None).

        ``device_s`` is the batch's measured device interval (on the card
        the CUDA events around its program's call, on the CPU the host
        interval); ``flops`` the analytic matmul-FLOP count of the batch
        (utils/flops.py; None skips the MFU gauge); ``cost`` the program's
        static cost record (serving/programs.static_cost; None skips the
        bandwidth/ceiling gauges); ``samples`` the total
        importance samples the batch actually drew (adaptive-k dispatches
        — attribution at measured ``k_used``, so device-time burn can't be
        gamed by easy rows charged at the cap; None for fixed-k traffic).
        Non-positive intervals (a clock artifact) are clamped to zero,
        counted, and excluded from the baseline — the detector must never
        learn from (or alarm on) a negative duration."""
        cfg = self.config
        if device_s <= 0.0:
            self.registry.counter("prof/clamped_intervals").inc()
            return None
        key = self._key(program, bucket, k_class)
        mfu = hbm_frac = ceiling_ratio = None
        pf = self.peaks.get("peak_flops")
        pb = self.peaks.get("peak_hbm_bytes")
        if flops and pf:
            mfu = (flops / device_s) / pf
        if cost and pb and cost.get("bytes_accessed_fused"):
            hbm_frac = (float(cost["bytes_accessed_fused"]) / device_s) / pb
        floor = self.static_floor_s(cost, self.peaks)
        if floor:
            ceiling_ratio = device_s / floor

        finding = None
        with self._lock:
            st = self._keys.get(key)
            if st is None:
                st = self._keys[key] = _KeyState()
            z = None
            if st.count >= cfg.warmup_samples:
                sigma = math.sqrt(max(st.ewvar, 0.0))
                sigma = max(sigma, cfg.min_sigma_frac * st.ewma)
                if sigma > 0.0:
                    z = (device_s - st.ewma) / sigma
                    if z > cfg.z_threshold:
                        self._seq += 1
                        if len(self._findings) == self._findings.maxlen:
                            self._dropped_findings += 1
                        finding = DriftFinding(
                            kind="prof/drift", key=key, program=program,
                            model=self.label, bucket=int(bucket),
                            k_class=str(k_class),
                            measured_s=float(device_s),
                            baseline_s=float(st.ewma),
                            sigma_s=float(sigma), z=float(z),
                            ratio=float(device_s / st.ewma)
                            if st.ewma > 0 else float("inf"),
                            seq=self._seq)
                        self._findings.append(finding)
            # baseline update AFTER the check (a drifted sample still
            # feeds the EWMA: a persistent slowdown converges to the new
            # normal instead of alarming forever)
            if st.count == 0:
                st.ewma = float(device_s)
            else:
                delta = device_s - st.ewma
                st.ewma += cfg.ewma_alpha * delta
                st.ewvar = ((1.0 - cfg.ewma_alpha)
                            * (st.ewvar + cfg.ewma_alpha * delta * delta))
            st.count += 1
            st.last_s = float(device_s)
            st.last_mfu = mfu
            st.last_hbm_frac = hbm_frac
            st.last_ceiling_ratio = ceiling_ratio
            st.last_z = z
            if samples is not None and rows > 0:
                k_used = float(samples) / float(rows)
                st.last_k_used = k_used
                st.ewma_k_used = k_used if st.ewma_k_used is None else \
                    st.ewma_k_used + cfg.ewma_alpha * (k_used
                                                       - st.ewma_k_used)

        # publish OUTSIDE the profiler lock (leaf-lock discipline: the
        # registry has its own lock and never calls back)
        reg = self.registry
        reg.histogram(f"prof/device_s/{key}").record(device_s)
        reg.counter("prof/dispatches").inc()
        reg.counter("prof/rows").inc(int(rows))
        if mfu is not None:
            reg.gauge(f"prof/mfu/{key}").set(mfu)
        if hbm_frac is not None:
            reg.gauge(f"prof/hbm_frac/{key}").set(hbm_frac)
        if ceiling_ratio is not None:
            reg.gauge(f"prof/ceiling_ratio/{key}").set(ceiling_ratio)
        if z is not None:
            reg.gauge(f"prof/z/{key}").set(z)
        if samples is not None:
            reg.counter("prof/samples").inc(int(samples))
            if rows > 0:
                reg.gauge(f"prof/k_used/{key}").set(float(samples)
                                                    / float(rows))
        if finding is not None:
            reg.counter("prof/drift").inc()
        return finding

    # -- read surfaces ------------------------------------------------------

    def findings(self, limit: Optional[int] = None) -> List[dict]:
        """The retained typed ``prof/drift`` findings, oldest first
        (``limit`` keeps the most recent N)."""
        with self._lock:
            docs = [f.to_dict() for f in self._findings]
        return docs[-limit:] if limit is not None else docs

    def snapshot(self) -> dict:
        """The profiling-plane document (``/prof``, ``iwae-prof``; schema
        pinned in tests/test_torch_observability.py): per-key measured state +
        EWMA baselines, the chip peaks in use, and the finding ring."""
        with self._lock:
            keys = {}
            for key, st in self._keys.items():
                doc = {
                    "count": st.count,
                    "ewma_s": st.ewma,
                    "sigma_s": math.sqrt(max(st.ewvar, 0.0)),
                    "last_s": st.last_s,
                    "last_mfu": st.last_mfu,
                    "last_hbm_frac": st.last_hbm_frac,
                    "last_ceiling_ratio": st.last_ceiling_ratio,
                    "last_z": st.last_z,
                }
                # k_used attribution only exists for keys that reported
                # sample counts (adaptive-k traffic) — fixed-k keys keep
                # the original schema (tests/test_torch_observability.py)
                if st.ewma_k_used is not None:
                    doc["ewma_k_used"] = st.ewma_k_used
                    doc["last_k_used"] = st.last_k_used
                keys[key] = doc
            findings = [f.to_dict() for f in self._findings]
            dropped = self._dropped_findings
        return {
            "label": self.label,
            "peaks": dict(self.peaks),
            "config": {
                "ewma_alpha": self.config.ewma_alpha,
                "z_threshold": self.config.z_threshold,
                "warmup_samples": self.config.warmup_samples,
            },
            "keys": keys,
            "findings": findings,
            "dropped_findings": dropped,
        }

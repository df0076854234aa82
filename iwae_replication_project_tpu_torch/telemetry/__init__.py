"""Telemetry (port of ``telemetry/``).

* :mod:`.registry` -- counters, gauges and log-spaced histograms behind one
  process-default :class:`MetricRegistry` (:func:`get_registry`);
* :mod:`.spans` -- nested host-side :func:`span` timing that lands in the
  registry and, under the same names, in ``torch.profiler`` traces;
* :mod:`.exporters` -- the Prometheus page and the ``/metrics``,
  ``/traces``, ``/prof`` and ``/healthz`` HTTP endpoints;
* :mod:`.tracing` -- per-request trace trees, the tail-sampled
  :class:`FlightRecorder`, Chrome trace-event export;
* :mod:`.slo` -- :class:`SLOMonitor`, multi-window burn-rate gauges;
* :mod:`.profiling` -- :class:`DispatchProfiler`, per-dispatch device-time
  attribution, measured MFU and bandwidth, EWMA drift findings;
* :mod:`.trace_cli` -- the flight-recorder dump over the wire;
* :mod:`.parity` -- :func:`statistical_parity`, the acceptance gate of the
  bf16 and int8 serving policies;
* :mod:`.diagnostics` -- the estimator diagnostics (imported by its call
  sites).
"""

from iwae_replication_project_tpu_torch.telemetry.exporters import (
    prometheus_text,
    start_metrics_server,
)
from iwae_replication_project_tpu_torch.telemetry.parity import (
    BF16_TOLERANCES,
    DEFAULT_TOLERANCES,
    INT8_TOLERANCES,
    ParityTolerances,
    statistical_parity,
)
from iwae_replication_project_tpu_torch.telemetry.profiling import (
    DispatchProfiler,
    DriftFinding,
    ProfilingConfig,
    detect_chip_peaks,
)
from iwae_replication_project_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    get_registry,
)
from iwae_replication_project_tpu_torch.telemetry.slo import (
    SLOMonitor,
    SLOObjective,
)
from iwae_replication_project_tpu_torch.telemetry.spans import (
    current_span,
    span,
    spanned,
)
from iwae_replication_project_tpu_torch.telemetry.tracing import (
    FlightRecorder,
    TraceContext,
    chrome_trace_events,
    get_recorder,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricRegistry", "get_registry",
    "current_span", "span", "spanned",
    "prometheus_text", "start_metrics_server",
    "FlightRecorder", "TraceContext", "chrome_trace_events", "get_recorder",
    "SLOMonitor", "SLOObjective",
    "DispatchProfiler", "DriftFinding", "ProfilingConfig",
    "detect_chip_peaks",
    "ParityTolerances", "BF16_TOLERANCES", "INT8_TOLERANCES",
    "DEFAULT_TOLERANCES", "statistical_parity",
]

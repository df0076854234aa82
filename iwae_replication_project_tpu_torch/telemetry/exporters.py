"""Registry exporters: the Prometheus page and the metrics HTTP server (port
of ``telemetry/exporters.py``, a framework-free copy on the port's registry).

* :func:`prometheus_text` -- the registry as a Prometheus text-format page
  (counters as ``*_total``, gauges, histograms as summaries with quantile
  labels), with ``# HELP`` lines per family (the JAX module's texts,
  verbatim: the page is byte-equal to the JAX page for the same registry
  contents) and the histogram ``_sum`` taken from the Histogram's exact
  ``total``. Same-name collisions across merged registries stay
  last-writer-wins but are counted on the process registry's
  ``telemetry/export_collisions`` counter;
* :func:`start_metrics_server` -- a daemon-thread HTTP endpoint serving that
  page at ``/metrics``, plus, when handed a flight recorder
  (telemetry/tracing.py), the retained request traces as Chrome trace-event
  JSON at ``/traces``; when handed dispatch profilers
  (telemetry/profiling.py), their snapshots at ``/prof``; and liveness at
  ``/healthz``, all of which the serving CLI exposes via ``--metrics-port``.

Dependency-free (stdlib http.server); the server snapshots the registry per
request, so a long-lived scrape always sees current values.
"""

from __future__ import annotations

import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

from iwae_replication_project_tpu_torch.telemetry.registry import (
    MetricRegistry,
)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

#: summary-key -> prometheus quantile label (accepts unit-suffixed variants
#: like ``p50_s`` from the serving latency histograms)
_QUANTILES = (("p50", "0.5"), ("p95", "0.95"), ("p99", "0.99"))


#: name-prefix -> # HELP text (first match wins; anything unlisted gets a
#: generic line naming the original slash-path)
_HELP_PREFIXES = (
    ("latency/", "per-request serving latency in seconds, by "
                 "(model, op, bucket)"),
    ("queue_wait/", "submit-to-device-enqueue wait in seconds "
                    "(coalescing + in-flight backpressure)"),
    ("device_wait/", "device-enqueue-to-fetch wait in seconds "
                     "(compute + D2H)"),
    ("router/", "serving-tier replica router accounting"),
    ("slo/", "SLO burn-rate accounting: violation fraction over the "
             "trailing window divided by the error budget (1 - target)"),
    ("span/", "host-side span wall time in seconds (telemetry/spans.py)"),
    ("store/", "process executable-store accounting "
               "(utils/compile_cache.py)"),
    ("kernel/", "hot-loop path selected per (op, bucket, k) dispatch "
                "config (ops/hot_loop.PATH_CODES)"),
    ("autotune/", "tile/remat autotuner accounting (ops/autotune.py)"),
    ("telemetry/", "telemetry-pipeline self-accounting"),
    ("diag/", "on-device estimator diagnostics "
              "(telemetry/diagnostics.py)"),
    ("prof/", "continuous profiling plane: per-dispatch device time, "
              "measured MFU/bandwidth vs static roofline ceilings, and "
              "EWMA drift accounting (telemetry/profiling.py)"),
)


def _escape_help(text: str) -> str:
    """Escape a ``# HELP`` value per the exposition format: backslash and
    newline (a raw newline would terminate the comment mid-value and turn
    the remainder into a garbage sample line)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(value: str) -> str:
    """Escape a label VALUE per the exposition format: backslash,
    double-quote, newline — the three characters that would otherwise
    terminate or corrupt the quoted string."""
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _help_for(name: str, kind: str) -> str:
    for prefix, text in _HELP_PREFIXES:
        if name.startswith(prefix):
            return _escape_help(text)
    return _escape_help(f"iwae {kind} {name!r}")


def _sanitize(name: str) -> str:
    n = _NAME_RE.sub("_", name)
    return n if not n[:1].isdigit() else "_" + n


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


def prometheus_text(registries, namespace: str = "iwae") -> str:
    """Render one or more registries as a Prometheus exposition page.

    Later registries win on name collisions — pass the process-default
    registry first and subsystem registries after it.  Every collision is
    counted on the process registry's ``telemetry/export_collisions``
    counter (visible from the NEXT scrape), so a shadowed metric is a
    visible condition instead of a silently wrong dashboard.
    """
    if isinstance(registries, MetricRegistry):
        registries = (registries,)
    counters, gauges, hists = {}, {}, {}
    collisions = 0
    for reg in registries:
        snap = reg.snapshot()
        for src, dst in ((snap["counters"], counters),
                         (snap["gauges"], gauges),
                         (snap["histograms"], hists)):
            for k, v in src.items():
                if k in dst:
                    collisions += 1
                dst[k] = v
    if collisions:
        from iwae_replication_project_tpu_torch.telemetry.registry import (
            get_registry)
        get_registry().counter("telemetry/export_collisions").inc(collisions)

    lines = []
    for name, v in sorted(counters.items()):
        m = f"{namespace}_{_sanitize(name)}_total"
        lines += [f"# HELP {m} {_help_for(name, 'counter')}",
                  f"# TYPE {m} counter", f"{m} {_fmt(v)}"]
    for name, v in sorted(gauges.items()):
        m = f"{namespace}_{_sanitize(name)}"
        lines += [f"# HELP {m} {_help_for(name, 'gauge')}",
                  f"# TYPE {m} gauge", f"{m} {_fmt(v)}"]
    for name, s in sorted(hists.items()):
        m = f"{namespace}_{_sanitize(name)}"
        lines.append(f"# HELP {m} {_help_for(name, 'summary')}")
        lines.append(f"# TYPE {m} summary")
        for key, label in _QUANTILES:
            v = next((s[k] for k in (key, key + "_s") if s.get(k) is not None),
                     None)
            if v is not None:
                lines.append(
                    f'{m}{{quantile="{_escape_label(label)}"}} {_fmt(v)}')
        count = s.get("count") or 0
        lines.append(f"{m}_count {_fmt(count)}")
        # _sum from the histogram's exact tracked total; the mean * count
        # reconstruction (pre-satellite behavior) only as a fallback for
        # foreign summaries that never carried one
        total = next((s[k] for k in ("total", "total_s")
                      if s.get(k) is not None), None)
        if total is None:
            mean = next((s[k] for k in ("mean", "mean_s")
                         if s.get(k) is not None), None)
            total = mean * count if mean is not None else None
        if total is not None:
            lines.append(f"{m}_sum {_fmt(total)}")
    return "\n".join(lines) + "\n"


class _MetricsHandler(BaseHTTPRequestHandler):
    registries: Sequence[MetricRegistry] = ()
    recorder = None     # optional FlightRecorder backing /traces
    profilers: Sequence = ()   # optional DispatchProfilers backing /prof
    health = None       # optional callable -> liveness dict backing /healthz

    def _send_json(self, doc, status: int = 200) -> None:
        import json

        body = json.dumps(doc).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server API)
        path = self.path.split("?")[0]
        if path == "/traces":
            self._serve_traces()
            return
        if path == "/prof":
            self._serve_prof()
            return
        if path == "/healthz":
            self._serve_healthz()
            return
        if path not in ("/", "/metrics"):
            self.send_error(404)
            return
        body = prometheus_text(self.registries).encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _serve_traces(self):
        """Retained flight-recorder traces as Chrome trace-event JSON —
        save the response body and load it in chrome://tracing/Perfetto
        (the ``iwae-trace`` CLI does the same over the wire op)."""
        if self.recorder is None:
            self.send_error(404, "tracing is not enabled on this server")
            return
        from iwae_replication_project_tpu_torch.telemetry.tracing import (
            chrome_trace_events)
        self._send_json(chrome_trace_events(self.recorder.traces()))

    def _serve_prof(self):
        """The profiling-plane snapshot(s) (telemetry/profiling.py): one
        document per attached profiler — per-key measured/EWMA state, the
        chip peaks in use, and the retained ``prof/drift`` findings."""
        if not self.profilers:
            self.send_error(404, "profiling is not enabled on this server")
            return
        self._send_json({"profilers": [p.snapshot() for p in self.profilers]})

    def _serve_healthz(self):
        """Tier liveness for the fleet controller and external probes:
        200 + the liveness document when healthy, 503 when the provider
        reports unhealthy OR raises (a dying tier must read as down, not
        as a scrape error)."""
        doc, ok = {"ok": True}, True
        if self.health is not None:
            try:
                doc = dict(self.health())
                ok = bool(doc.get("ok", True))
            except Exception as e:
                doc, ok = {"ok": False, "error": str(e)}, False
        self._send_json(doc, status=200 if ok else 503)

    def log_message(self, *args):  # scrapes must not spam the serving stdout
        pass


class _MetricsServer(ThreadingHTTPServer):
    def shutdown(self):
        """Stop serving AND close the listening socket — the stock
        ThreadingHTTPServer leaves the socket bound after shutdown(), which
        leaks the fd and EADDRINUSEs the next fixed-port start."""
        super().shutdown()
        self.server_close()


def start_metrics_server(registries, port: int,
                         host: str = "127.0.0.1",
                         recorder=None, profilers=None,
                         health=None) -> ThreadingHTTPServer:
    """Serve ``/metrics`` in a daemon thread; returns the live server
    (``.server_address[1]`` is the bound port — pass ``port=0`` for an
    ephemeral one; ``.shutdown()`` stops it and releases the port).
    ``recorder`` (a :class:`~.tracing.FlightRecorder`) additionally serves
    its retained traces as Chrome trace-event JSON at ``/traces``;
    ``profilers`` (an iterable of :class:`~.profiling.DispatchProfiler`)
    serves their merged snapshots at ``/prof``; ``health`` (a zero-arg
    callable returning a liveness dict with an ``ok`` key) backs
    ``/healthz`` — 200 when ok, 503 when not (or when the callable
    raises). ``/healthz`` always answers: with no callable it reports
    bare process liveness ``{"ok": true}``."""
    if isinstance(registries, MetricRegistry):
        registries = (registries,)

    class Handler(_MetricsHandler):
        pass

    Handler.registries = tuple(registries)
    Handler.recorder = recorder
    Handler.profilers = tuple(profilers) if profilers else ()
    # staticmethod: a bare function set as a class attribute would bind as
    # a method and receive the handler as a bogus first argument
    Handler.health = staticmethod(health) if health is not None else None
    srv = _MetricsServer((host, port), Handler)
    threading.Thread(target=srv.serve_forever, name="iwae-metrics-http",
                     daemon=True).start()
    return srv

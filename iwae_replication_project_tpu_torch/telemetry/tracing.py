"""Request tracing: trace context, spans, the tail-sampled flight recorder
(port of ``telemetry/tracing.py``; framework-free, so a copy).

One trace per request, threaded from the front end through quota
admission, router dispatch attempts, ``RemoteEngine`` hops and the
engine's pipeline stages, assembled into a tree and kept by a bounded
flight recorder.

* **explicit context, not thread-locals**: a request hops threads
  (connection reader, dispatcher, completion, router callback), so the
  context (:class:`TraceContext`: trace id, parent span id, recorder) rides
  the request itself;
* **record everything, retain a sample**: spans are recorded for every
  traced request; retention is decided when the trace completes: every
  trace with an error span is kept, the slowest tail (top
  ``slow_fraction`` of a rolling window of durations) is kept, and 1 in
  ``sample_every`` of the rest;
* **completion = all spans closed**: a trace finalizes when its open-span
  count returns to zero, so reroutes, hedges and cross-hop work land in
  the same tree; traces abandoned by a crashed participant expire after
  ``open_ttl_s`` (counted, never leaked);
* **tracing never touches results**: ids and timestamps live beside the
  (weights, payload, seed, k) request function, so results are bitwise the
  same with tracing on or off.

Wire format (``serving/frontend/protocol.py``): the request's ``trace``
field is ``"<trace-id>"`` or ``"<trace-id>/<parent-span-id>"``, each part
1-64 chars of ``[A-Za-z0-9_.:-]``. Anything else is a typed
``bad_request``.

Export: :func:`chrome_trace_events` renders retained traces as Chrome
trace-event JSON (``chrome://tracing``, Perfetto), which the tier's
``traces`` control op serves with ``format: "chrome"``.
"""

from __future__ import annotations

import itertools
import os
import re
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "FlightRecorder", "Span", "SpanRecord", "TraceContext",
    "chrome_trace_events", "emit_span", "get_recorder", "mint_trace_id",
    "parse_wire_trace", "start_span", "TRACE_WIRE_MAX_CHARS",
]

#: one wire ``trace`` part: 1-64 chars, URL/log-safe, no ``/`` (separator)
_PART_RE = re.compile(r"[A-Za-z0-9_.:\-]{1,64}\Z")
#: the full wire field bound (two parts + separator) — anything longer is
#: a typed ``bad_request`` at the protocol surface, never server bloat
TRACE_WIRE_MAX_CHARS = 129

#: process-unique id material: a random process tag + a monotonic counter
#: (``itertools.count.__next__`` is atomic in CPython) — ids are opaque
#: labels and deliberately NOT drawn from any RNG the models use, so
#: tracing can never perturb a sampled weight
_PROC_TAG = os.urandom(4).hex()
_IDS = itertools.count(1)


def mint_trace_id() -> str:
    """A fresh 16-hex-char trace id (collision-safe across processes)."""
    return os.urandom(8).hex()


def _mint_span_id() -> str:
    return f"{_PROC_TAG}-{next(_IDS):x}"


def parse_wire_trace(value: Any) -> Tuple[str, Optional[str]]:
    """Validate one wire ``trace`` field -> ``(trace_id, parent_span_id)``.

    Raises ValueError (the typed ``bad_request`` upstream) for non-strings,
    oversized fields, extra parts, or parts outside the charset — a
    malformed trace must never take the connection down or grow server
    state."""
    if not isinstance(value, str):
        raise ValueError(
            f"'trace' must be a string, got {type(value).__name__}")
    if len(value) > TRACE_WIRE_MAX_CHARS:
        raise ValueError(
            f"'trace' exceeds {TRACE_WIRE_MAX_CHARS} chars ({len(value)})")
    parts = value.split("/")
    if len(parts) > 2:
        raise ValueError("'trace' is '<trace-id>' or "
                         "'<trace-id>/<parent-span-id>' (one '/' at most)")
    for p in parts:
        if not _PART_RE.fullmatch(p):
            raise ValueError(
                "'trace' parts must be 1-64 chars of [A-Za-z0-9_.:-]")
    return parts[0], (parts[1] if len(parts) == 2 else None)


class SpanRecord:
    """One finished span (immutable once recorded)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t_start",
                 "t_end", "attrs", "error")

    def __init__(self, trace_id: str, span_id: str, parent_id: Optional[str],
                 name: str, t_start: float, t_end: float,
                 attrs: Optional[dict], error: Optional[str]):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t_start = t_start
        self.t_end = t_end
        self.attrs = attrs
        self.error = error

    def doc(self) -> Dict[str, Any]:
        """The span's JSON document (the flight-recorder schema tests pin)."""
        return {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "t_start_s": self.t_start,
            "duration_s": max(0.0, self.t_end - self.t_start),
            "attrs": dict(self.attrs) if self.attrs else {},
            "error": self.error,
        }


class TraceContext:
    """Where a child span attaches: (recorder, trace id, parent span id)."""

    __slots__ = ("recorder", "trace_id", "span_id")

    def __init__(self, recorder: "FlightRecorder", trace_id: str,
                 span_id: str):
        self.recorder = recorder
        self.trace_id = trace_id
        self.span_id = span_id

    def wire(self) -> str:
        """The context as the protocol ``trace`` field (the hop format)."""
        return f"{self.trace_id}/{self.span_id}"


class Span:
    """A live span: created by :func:`start_span`, closed by :meth:`finish`.

    Owned by the flow that created it — fields are written by one logical
    owner at a time (the request's current hop), never concurrently; the
    recorder's lock serializes the actual recording."""

    __slots__ = ("_recorder", "trace_id", "span_id", "parent_id", "name",
                 "t_start", "attrs", "_done")

    def __init__(self, recorder: "FlightRecorder", trace_id: str,
                 parent_id: Optional[str], name: str, t_start: float,
                 attrs: Optional[dict]):
        self._recorder = recorder
        self.trace_id = trace_id
        self.span_id = _mint_span_id()
        self.parent_id = parent_id
        self.name = name
        self.t_start = t_start
        self.attrs = dict(attrs) if attrs else None
        self._done = False
        recorder._begin(trace_id)

    def ctx(self) -> TraceContext:
        """The context children (local or over-the-wire) attach under."""
        return TraceContext(self._recorder, self.trace_id, self.span_id)

    def annotate(self, **attrs) -> "Span":
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(attrs)
        return self

    def child(self, name: str, attrs: Optional[dict] = None) -> "Span":
        return start_span(name, ctx=self.ctx(), attrs=attrs)

    def finish(self, error: Optional[str] = None,
               t_end: Optional[float] = None) -> None:
        """Record the span (idempotent: reroute/hedge races may try twice;
        the first close wins). `error` is the typed code (or any short
        label) that marks the whole trace error-retained."""
        if self._done:
            return
        self._done = True
        t_end = time.monotonic() if t_end is None else t_end
        self._recorder._record(SpanRecord(
            self.trace_id, self.span_id, self.parent_id, self.name,
            self.t_start, t_end, self.attrs, error), opened=True)


def start_span(name: str, *, ctx: Optional[TraceContext] = None,
               recorder: Optional["FlightRecorder"] = None,
               trace_id: Optional[str] = None,
               parent_id: Optional[str] = None,
               attrs: Optional[dict] = None,
               t_start: Optional[float] = None) -> Span:
    """Open a span: under `ctx` (child), or rooting/joining a trace.

    With ``ctx``, the span is a child in that context's trace.  Without it,
    ``trace_id``/``parent_id`` join an existing trace (the wire-accept
    path) or — both absent — mint a fresh trace (the front end's root)."""
    if ctx is not None:
        rec, tid, pid = ctx.recorder, ctx.trace_id, ctx.span_id
    else:
        rec = recorder if recorder is not None else get_recorder()
        tid = trace_id if trace_id is not None else mint_trace_id()
        pid = parent_id
    return Span(rec, tid, pid, name,
                time.monotonic() if t_start is None else t_start, attrs)


def emit_span(ctx: TraceContext, name: str, t_start: float, t_end: float,
              attrs: Optional[dict] = None,
              error: Optional[str] = None) -> None:
    """Record one already-timed span under `ctx` (the engine pipeline's
    stage spans: timestamps were stamped on the hot path, the record is
    assembled at completion — zero tracing work between them)."""
    ctx.recorder._record(SpanRecord(
        ctx.trace_id, _mint_span_id(), ctx.span_id, name, t_start, t_end,
        attrs, error), opened=False)


class _OpenTrace:
    """In-progress trace state (guarded by the owning recorder's lock)."""

    __slots__ = ("records", "open_spans", "t_created")

    def __init__(self, t_created: float):
        self.records: List[SpanRecord] = []
        self.open_spans = 0
        self.t_created = t_created


class FlightRecorder:
    """Bounded, tail-sampling store of completed request traces.

    ``capacity`` bounds the retained ring; ``sample_every`` keeps
    1-in-N healthy/fast traces (1 = keep everything);
    ``slow_fraction`` keeps the slowest tail against a rolling window of
    recent trace durations (armed once ``slow_min_history`` durations have
    been seen — before that, only errors and the 1-in-N sample retain);
    ``max_open``/``open_ttl_s`` bound in-progress state against abandoned
    traces.  One instance per process by default (:func:`get_recorder`);
    tests build isolated ones.
    """

    #: rolling-duration window backing the slow-tail threshold
    _DUR_WINDOW = 256

    def __init__(self, capacity: int = 256, sample_every: int = 16,
                 slow_fraction: float = 0.05, slow_min_history: int = 32,
                 max_open: int = 4096, open_ttl_s: float = 120.0,
                 clock: Callable[[], float] = time.monotonic):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if sample_every < 1:
            raise ValueError(
                f"sample_every must be >= 1, got {sample_every}")
        self.capacity = int(capacity)
        self.sample_every = int(sample_every)
        self.slow_fraction = float(slow_fraction)
        self.slow_min_history = int(slow_min_history)
        self.max_open = int(max_open)
        self.open_ttl_s = float(open_ttl_s)
        self._clock = clock
        # RLock: the finalize/expire helpers re-take it so EVERY write to
        # the shared state is visibly under the lock (the concurrency
        # checker's discipline; same idiom as utils/compile_cache.py)
        self._lock = threading.RLock()
        self._open: Dict[str, _OpenTrace] = {}
        self._ring: "deque[dict]" = deque(maxlen=self.capacity)
        self._durations: "deque[float]" = deque(maxlen=self._DUR_WINDOW)
        self._finalized = 0
        self._counters = {
            "traces_started": 0, "finalized": 0, "kept_error": 0,
            "kept_slow": 0, "kept_sampled": 0, "dropped": 0,
            "late_spans": 0, "open_overflow": 0, "abandoned": 0,
        }

    # -- span intake (called by Span/emit_span) -----------------------------

    def _begin(self, trace_id: str) -> None:
        """Register an opening span (creates the trace on first touch)."""
        with self._lock:
            t = self._open.get(trace_id)
            if t is None:
                if len(self._open) >= self.max_open:
                    self._expire_open(self._clock())
                if len(self._open) >= self.max_open:
                    # still full: refuse the new trace; its spans will be
                    # counted late and dropped — bounded memory beats
                    # completeness for a recorder
                    self._counters["open_overflow"] += 1
                    return
                t = self._open[trace_id] = _OpenTrace(self._clock())
                self._counters["traces_started"] += 1
            t.open_spans += 1

    def _record(self, rec: SpanRecord, opened: bool) -> None:
        finalize = None
        with self._lock:
            t = self._open.get(rec.trace_id)
            if t is None:
                self._counters["late_spans"] += 1
                return
            t.records.append(rec)
            if opened:
                t.open_spans -= 1
            if t.open_spans <= 0:
                finalize = self._open.pop(rec.trace_id)
        if finalize is not None:
            self._finalize_trace(rec.trace_id, finalize)

    # -- completion + tail sampling -----------------------------------------

    def _finalize_trace(self, trace_id: str, t: _OpenTrace) -> None:
        """Tail-sample one completed trace into the ring. `t` has already
        been popped from the open set, so this re-entrant lock section is
        the only writer that will ever see it."""
        records = t.records
        t0 = min(r.t_start for r in records)
        t1 = max(r.t_end for r in records)
        duration = max(0.0, t1 - t0)
        error = any(r.error is not None for r in records)
        with self._lock:
            # slow threshold BEFORE this duration joins the window (a burst
            # of identical requests must not all read as "slow vs itself")
            slow = False
            if len(self._durations) >= self.slow_min_history:
                ds = sorted(self._durations)
                idx = min(len(ds) - 1,
                          int(len(ds) * (1.0 - self.slow_fraction)))
                # STRICTLY above the threshold: a uniform workload (every
                # duration equal) has no tail and must not read as all-slow
                slow = duration > ds[idx]
            self._durations.append(duration)
            n = self._finalized
            self._finalized += 1
            self._counters["finalized"] += 1
            if error:
                kept = "error"
                self._counters["kept_error"] += 1
            elif slow:
                kept = "slow"
                self._counters["kept_slow"] += 1
            elif n % self.sample_every == 0:
                kept = "sampled"
                self._counters["kept_sampled"] += 1
            else:
                self._counters["dropped"] += 1
                return
            ids = {r.span_id for r in records}
            roots = [r for r in records
                     if r.parent_id is None or r.parent_id not in ids]
            records.sort(key=lambda r: r.t_start)
            self._ring.append({
                "trace_id": trace_id,
                "root": roots[0].name if roots else records[0].name,
                "duration_s": duration,
                "error": error,
                "kept": kept,
                "spans": [r.doc() for r in records],
            })

    def _expire_open(self, now: float) -> None:
        """Drop in-progress traces older than the TTL (abandoned by a
        crashed participant); called with the RLock already held."""
        with self._lock:
            stale = [tid for tid, t in self._open.items()
                     if now - t.t_created > self.open_ttl_s]
            for tid in stale:
                del self._open[tid]
                self._counters["abandoned"] += 1

    # -- export -------------------------------------------------------------

    def traces(self, limit: Optional[int] = None,
               trace_id: Optional[str] = None) -> List[dict]:
        """Retained trace documents, oldest first (``limit`` keeps the most
        recent N; ``trace_id`` filters — the histogram-exemplar lookup)."""
        with self._lock:
            docs = list(self._ring)
        if trace_id is not None:
            docs = [d for d in docs if d["trace_id"] == trace_id]
        if limit is not None and limit >= 0:
            # limit=0 means NO bodies (a stats-only query), not docs[-0:]
            # (which would slice the whole ring)
            docs = docs[-int(limit):] if limit else []
        return docs

    def stats(self) -> Dict[str, Any]:
        """Recorder accounting (the JAX package's schema)."""
        with self._lock:
            out = dict(self._counters)
            out["retained"] = len(self._ring)
            out["open"] = len(self._open)
        out["capacity"] = self.capacity
        out["sample_every"] = self.sample_every
        out["slow_fraction"] = self.slow_fraction
        return out

    def clear(self) -> None:
        """Drop retained and in-progress traces (tests between
        phases); counters keep counting."""
        with self._lock:
            self._ring.clear()
            self._open.clear()


def chrome_trace_events(trace_docs: List[dict]) -> Dict[str, Any]:
    """Retained trace documents as a Chrome trace-event JSON object.

    Each trace renders as one synthetic thread (``tid``) so its spans nest
    visually by time; span/parent/trace ids and attrs ride ``args``.
    Loadable in ``chrome://tracing`` and Perfetto.
    """
    events: List[dict] = []
    pid = os.getpid()
    for i, doc in enumerate(trace_docs):
        tid = i + 1
        events.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": f"trace {doc['trace_id']} "
                             f"({doc['kept']}, {doc['root']})"},
        })
        for s in doc["spans"]:
            args = dict(s["attrs"])
            args.update({"trace_id": doc["trace_id"],
                         "span_id": s["span_id"],
                         "parent_id": s["parent_id"]})
            if s["error"] is not None:
                args["error"] = s["error"]
            events.append({
                "ph": "X", "cat": "iwae", "name": s["name"],
                "pid": pid, "tid": tid,
                "ts": round(s["t_start_s"] * 1e6, 3),
                "dur": round(s["duration_s"] * 1e6, 3),
                "args": args,
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


#: the process-default flight recorder: the serving tier, RemoteEngine hops
#: and the in-process client all record here unless handed an instance —
#: one recorder = one assembled tree when client and fleet share a process
_DEFAULT = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return _DEFAULT

"""Hierarchical span tracing: one name, three sinks (port of
``telemetry/spans.py``, with a span recorder of its own).

``with span("train/stage"):`` nests (a thread-local stack joins names into a
path like ``train/stage/train/epoch``), and on exit the wall time lands in

* the metric registry: histogram ``span/<path>`` (p50/p95/p99 + count),
  exported with everything else (JSONL rows, the Prometheus page);
* ``torch.profiler.record_function(<path>)`` in place of JAX's
  ``TraceAnnotation``: the same names appear as host ranges of a
  ``torch.profiler`` trace that records host operations
  (``utils/profiling.trace``), beside the kernels the section launched;
* the span recorder :data:`REC`, while it records (below).

**The recorder.** Off by default; :func:`start` (or :func:`recording`)
turns it on with a bounded buffer, :func:`drain` takes what it holds. While
on, each span appends one record: its name, its own id, the id of the span
open around it on the same thread, the thread, start and end, and a few
attrs (the pass, the batch, the chunk: the identifiers the spans of one
pass or one NLL batch share). Start and end are ``time.time_ns()``, the
Unix-epoch clock of the host events of a ``torch.profiler`` trace, so
records line up with a CUDA-only trace of the same process without
profiling host operations. A span opened with ``device=True`` also records
a ``torch.cuda.Event(enable_timing=True)`` on the current stream at enter
and exit; their ``elapsed_time`` is read in :func:`drain`, after the
caller's own synchronize, never inside the program. A full buffer counts
what it drops. The recorder also keeps counters and per-name sequence
numbers, while on. Nothing is written out: the caller drains and writes.

The program's hot sites (a graph replay, an NLL chunk) test
``REC.on`` and call :meth:`Recorder.begin` / :meth:`Recorder.end` only when
it is set: off, a site costs one flag test, with no histogram, no
``record_function`` and no allocation. A site timed whatever the recorder
does (a capture: its seconds feed the compile-cache counters) calls
``begin``/``end`` unconditionally; off, that records nothing.

Spans are host-side: around dispatches, stages, request handling, replays.
A span never sits inside a CUDA-graph capture (it would run at capture time
only): it wraps the host call that replays a captured graph, and a span
begun on a stream that is capturing is not recorded.

Left out: JAX's ``kernel/select/*`` spans (JAX ``ops/hot_loop.py:446,963``)
time the TPU's VMEM probes, which the port does not have.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch

from iwae_replication_project_tpu_torch.telemetry.registry import (
    MetricRegistry,
    get_registry,
)

#: records a recorder keeps unless :func:`start` is given another bound
DEFAULT_CAPACITY = 1 << 18

_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _open_ids() -> list:
    st = getattr(_tls, "open", None)
    if st is None:
        st = _tls.open = []
    return st


def current_span() -> Optional[str]:
    """The innermost active span's full path on this thread, or None."""
    st = _stack()
    return st[-1] if st else None


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One span as :func:`drain` gives it."""

    name: str
    id: int
    #: the id of the span open around it on its thread when it began
    #: (None: none, or one begun before the recorder started)
    parent: Optional[int]
    thread: int
    #: ``time.time_ns()`` at enter and exit
    t_start_ns: int
    t_end_ns: int
    attrs: Dict[str, int]
    #: device time between its CUDA events; None without them
    device_ms: Optional[float] = None

    @property
    def host_ns(self) -> int:
        return self.t_end_ns - self.t_start_ns


@dataclasses.dataclass(frozen=True)
class Drained:
    """What the recorder held: the closed spans by start, the counters,
    and the spans a full buffer dropped."""

    records: List[SpanRecord]
    counts: Dict[str, int]
    dropped: int

    def named(self, name: str) -> List[SpanRecord]:
        return [r for r in self.records if r.name == name]


class _Open:
    """A begun span: ``rec`` is its slot in the buffer (None when the
    recorder was off, capturing or full)."""

    __slots__ = ("t0", "id", "rec")

    def __init__(self, t0: int, id_: int = 0, rec: Optional[list] = None):
        self.t0, self.id, self.rec = t0, id_, rec


class Recorder:
    """The process's span recorder (module note); :data:`REC` is the one
    the program's sites use."""

    def __init__(self):
        self.on = False
        self._lock = threading.Lock()
        self.capacity = DEFAULT_CAPACITY
        #: ``[name, id, parent, thread, t0, t1, attrs, ev0, ev1]`` each
        self._buf: List[list] = []
        self._counts: Dict[str, int] = {}
        self._seqs: Dict[str, int] = {}
        self._dropped = 0
        self._next_id = 1
        self._capturing: Optional[Callable[[], bool]] = None

    def start(self, capacity: int = DEFAULT_CAPACITY) -> None:
        """Empty the buffer and record up to `capacity` spans."""
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        capturing = torch.cuda.is_current_stream_capturing \
            if torch.cuda.is_available() else None
        with self._lock:
            self.capacity = capacity
            self._buf, self._counts, self._seqs = [], {}, {}
            self._dropped = 0
            self._next_id = 1
            self._capturing = capturing
            self.on = True

    def stop(self) -> None:
        """Stop recording; what was recorded stays until drained."""
        with self._lock:
            self.on = False

    def begin(self, name: str, attrs: Optional[Dict[str, int]] = None,
              device: bool = False) -> _Open:
        """Open a span on this thread; pass the result to :meth:`end`.
        `device` adds the CUDA event pair."""
        t0 = time.time_ns()
        if not self.on or (self._capturing is not None
                           and self._capturing()):
            return _Open(t0)
        ids = _open_ids()
        with self._lock:
            id_ = self._next_id
            self._next_id += 1
            full = len(self._buf) >= self.capacity
            if full:
                self._dropped += 1
            else:
                rec = [name, id_, ids[-1] if ids else None,
                       threading.get_ident(), t0, 0, attrs or {}, None,
                       None]
                self._buf.append(rec)
        ids.append(id_)
        if full:
            return _Open(t0, id_)
        if device:
            rec[7] = torch.cuda.Event(enable_timing=True)
            rec[7].record()
        return _Open(t0, id_, rec)

    def end(self, sp: _Open) -> float:
        """Close `sp`; returns its host seconds (recorded or not)."""
        t1 = time.time_ns()
        rec = sp.rec
        if rec is not None:
            if rec[7] is not None:
                rec[8] = torch.cuda.Event(enable_timing=True)
                rec[8].record()
            rec[5] = t1
        if sp.id:
            ids = _open_ids()
            while ids and ids.pop() != sp.id:
                pass  # a span left open by an exception closes with it
        return (t1 - sp.t0) / 1e9

    @contextlib.contextmanager
    def section(self, name: str, attrs: Optional[Dict[str, int]] = None,
                device: bool = False) -> Iterator[_Open]:
        """``begin``/``end`` around a block (for sites that run once a
        pass or a batch)."""
        sp = self.begin(name, attrs, device)
        try:
            yield sp
        finally:
            self.end(sp)

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to counter `name` (call it while :attr:`on`)."""
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def next_seq(self, name: str) -> int:
        """0, 1, 2, ... per `name`: the pass or batch index of a span's
        attrs."""
        with self._lock:
            n = self._seqs.get(name, 0)
            self._seqs[name] = n + 1
        return n

    def drain(self) -> Drained:
        """Take every closed span (device times read from its events: the
        caller has synchronized), the counters and the dropped count, and
        empty the buffer. Recording goes on if it was on."""
        with self._lock:
            buf, counts, dropped = self._buf, self._counts, self._dropped
            self._buf, self._counts, self._dropped = [], {}, 0
        out = []
        for name, id_, parent, thread, t0, t1, attrs, ev0, ev1 in buf:
            if not t1:
                continue  # still open
            dev = ev0.elapsed_time(ev1) if ev1 is not None else None
            out.append(SpanRecord(name, id_, parent, thread, t0, t1, attrs,
                                  dev))
        return Drained(out, counts, dropped)


#: the recorder of this process
REC = Recorder()


def start(capacity: int = DEFAULT_CAPACITY) -> None:
    REC.start(capacity)


def stop() -> None:
    REC.stop()


def drain() -> Drained:
    return REC.drain()


@contextlib.contextmanager
def recording(capacity: int = DEFAULT_CAPACITY) -> Iterator[Recorder]:
    """Record spans inside the block; drain after it."""
    REC.start(capacity)
    try:
        yield REC
    finally:
        REC.stop()


@contextlib.contextmanager
def span(name: str,
         registry: Optional[MetricRegistry] = None) -> Iterator[str]:
    """Time a host-side section under `name`, nested inside any active span.

    Yields the full path. Exceptions propagate; the span still records (a
    failing dispatch's latency is exactly the one worth seeing).
    """
    reg = registry if registry is not None else get_registry()
    st = _stack()
    path = f"{st[-1]}/{name}" if st else name
    st.append(path)
    sp = REC.begin(name) if REC.on else None
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(path):
            yield path
    finally:
        st.pop()
        reg.histogram(f"span/{path}").record(time.perf_counter() - t0)
        if sp is not None:
            REC.end(sp)


def spanned(fn, name: str, registry: Optional[MetricRegistry] = None):
    """Wrap a callable so every invocation runs under ``span(name)``. The
    wrapper re-exposes the wrappee as ``__wrapped__`` (the JAX wrapper's
    ``.lower`` has no counterpart here)."""
    def call(*args, **kwargs):
        with span(name, registry=registry):
            return fn(*args, **kwargs)

    call.__name__ = getattr(fn, "__name__", name)
    call.__qualname__ = getattr(fn, "__qualname__", name)
    call.__wrapped__ = fn
    return call


__all__ = ["DEFAULT_CAPACITY", "Drained", "REC", "Recorder", "SpanRecord",
           "current_span", "drain", "recording", "span", "spanned", "start",
           "stop"]

"""Hierarchical span tracing: one name, two sinks (port of
``telemetry/spans.py``).

``with span("train/stage"):`` nests (a thread-local stack joins names into a
path like ``train/stage/train/epoch``), and on exit the wall time lands in

* the metric registry: histogram ``span/<path>`` (p50/p95/p99 + count),
  exported with everything else (JSONL rows, the Prometheus page);
* ``torch.profiler.record_function(<path>)`` in place of JAX's
  ``TraceAnnotation``: the same names appear as host ranges of a
  ``torch.profiler`` trace (``utils/profiling.trace``), beside the kernels
  the section launched.

Spans are host-side: around dispatches, stages, request handling. A span
never sits inside a CUDA-graph capture (it would run at capture time only):
it wraps the host call that replays a captured graph.

Left out: JAX's ``kernel/select/*`` spans (JAX ``ops/hot_loop.py:446,963``)
time the TPU's VMEM probes, which the port does not have.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator, Optional

import torch

from iwae_replication_project_tpu_torch.telemetry.registry import (
    MetricRegistry,
    get_registry,
)

_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_span() -> Optional[str]:
    """The innermost active span's full path on this thread, or None."""
    st = _stack()
    return st[-1] if st else None


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
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(path):
            yield path
    finally:
        st.pop()
        reg.histogram(f"span/{path}").record(time.perf_counter() - t0)


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


__all__ = ["current_span", "span", "spanned"]

"""The program's span records beside the device trace of the same run.

The port records spans while its recorder is on
(``iwae_replication_project_tpu_torch/telemetry/spans.py``): name, id,
parent id, ``time.time_ns()`` at enter and exit (the clock of the host
events of a ``torch.profiler`` trace, so a CUDA-only trace lines up with
them), attrs and, for spans opened with CUDA events, their device ms. A
record here is any object with the fields of the port's ``SpanRecord``.

This module puts them beside a :class:`~portbench.harness.trace.DeviceTrace`:

* :func:`self_ns`: a span's duration less the part its children cover;
* :func:`idle_gaps`, :func:`idle_by_span`: every idle gap the host caused
  (it launched the operation that ends the gap only after the device went
  idle) put down to the innermost program span open at that launch, and
  every other gap to a label that says why none is;
* :func:`table`: per span name, count, host ms, self ms, device ms and the
  idle put down to it, for standard error;
* the arithmetic of four per-layer readings: :func:`pass_device_ms`,
  :func:`capture_ms`, :func:`chunk_issue_ms` and :func:`host_idle_ms`.

Each reading is None where it finds no record to read: the CPU, or a run
whose recorder stayed off.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

from portbench.harness.trace import DeviceTrace

#: labels of idle no program span caused
IN_REPLAY = "inside a graph replay"
QUEUED = "launched before the gap"
NO_SPAN = "outside any program span"
NO_LAUNCH = "no launch call in the trace"
TAIL = "after the last operation"
NOT_SPANS = (IN_REPLAY, QUEUED, NO_SPAN, NO_LAUNCH, TAIL)


def _children(records: Sequence) -> Dict[int, list]:
    out: Dict[int, list] = defaultdict(list)
    for r in records:
        if r.parent is not None:
            out[r.parent].append(r)
    return out


def self_ns(records: Sequence) -> Dict[int, int]:
    """``{id: self ns}``: each span's duration less the union of its
    children's intervals inside it."""
    kids = _children(records)
    out = {}
    for r in records:
        covered, last = 0, r.t_start_ns
        for c in sorted(kids.get(r.id, ()), key=lambda c: c.t_start_ns):
            a, b = max(c.t_start_ns, last), min(c.t_end_ns, r.t_end_ns)
            if b > a:
                covered += b - a
                last = b
        out[r.id] = r.host_ns - covered
    return out


class _Innermost:
    """The innermost span open at an instant: of those whose interval holds
    it, the one that began last."""

    def __init__(self, records: Sequence):
        self.records = sorted(records, key=lambda r: r.t_start_ns)
        self.starts = [r.t_start_ns for r in self.records]

    def at(self, t: int):
        i = bisect.bisect_right(self.starts, t)
        for r in reversed(self.records[:i]):
            if r.t_end_ns >= t:
                return r
        return None


def idle_gaps(trace: DeviceTrace, records: Sequence) -> List[tuple]:
    """``(span name or label, idle ns)`` of every gap of the trace window,
    by time. A gap the host caused, one whose next operation's launch call
    began after the device went idle, goes to the innermost span open at
    that call (:data:`NO_SPAN` where none was). The others go to labels:
    :data:`QUEUED` where the call came before the gap (the device had the
    work and waited all the same), :data:`IN_REPLAY` where a graph launched
    the operation after the replay's first, :data:`NO_LAUNCH` where the
    trace holds no launch call for it, and :data:`TAIL` for the time after
    the last operation. The gaps sum to the trace's idle time."""
    segs = trace._segments  # the union of the device operations, by start
    if not segs:
        return []
    first_at = {o.start: o for o in trace.ops}
    in_replay = {id(o) for g in trace.graph_replays() for o in g[1:]}
    launches = {h.corr: h for h in trace.host
                if h.name.startswith(("cuda", "cu")) and h.corr}
    inner = _Innermost([r for r in records if r.t_end_ns >= trace.t0
                        and r.t_start_ns <= trace.t1])
    out = []
    ends = [trace.t0] + [e for _, e in segs]
    for (start, _), prev_end in zip(segs, ends):
        gap = start - prev_end
        if gap <= 0:
            continue
        op = first_at.get(start)
        call = launches.get(op.corr) if op is not None else None
        if op is not None and id(op) in in_replay:
            out.append((IN_REPLAY, gap))
        elif call is None:
            out.append((NO_LAUNCH, gap))
        elif call.start < prev_end:
            out.append((QUEUED, gap))
        else:
            r = inner.at(call.start)
            out.append((r.name if r is not None else NO_SPAN, gap))
    if trace.t1 > segs[-1][1]:
        out.append((TAIL, trace.t1 - segs[-1][1]))
    return out


def idle_by_span(trace: DeviceTrace, records: Sequence) -> Dict[str, int]:
    """:func:`idle_gaps` summed by span name or label."""
    out: Dict[str, int] = defaultdict(int)
    for label, gap in idle_gaps(trace, records):
        out[label] += gap
    return dict(out)


def table(records: Sequence, idle: Optional[Dict[str, int]] = None
          ) -> List[str]:
    """Lines of the per-span table: name, count, host ms, self ms, device
    ms (spans with events), idle ms put down to it; by host ms."""
    own = self_ns(records)
    rows: Dict[str, list] = {}
    for r in records:
        row = rows.setdefault(r.name, [0, 0, 0, None])
        row[0] += 1
        row[1] += r.host_ns
        row[2] += own[r.id]
        if r.device_ms is not None:
            row[3] = (row[3] or 0.0) + r.device_ms
    idle = idle or {}
    lines = [f"{'span':<24} {'count':>7} {'host ms':>11} {'self ms':>11} "
             f"{'device ms':>11} {'idle ms':>9}"]
    for name, (n, host, mine, dev) in sorted(rows.items(),
                                             key=lambda kv: -kv[1][1]):
        d = f"{dev:.3f}" if dev is not None else "-"
        lines.append(f"{name:<24} {n:>7} {host / 1e6:>11.3f} "
                     f"{mine / 1e6:>11.3f} {d:>11} "
                     f"{idle.get(name, 0) / 1e6:>9.3f}")
    for label in NOT_SPANS:
        if idle.get(label):
            lines.append(f"{label:<24} {'':>7} {'':>11} {'':>11} {'':>11} "
                         f"{idle[label] / 1e6:>9.3f}")
    return lines


# -- the per-layer readings ------------------------------------------------

def pass_device_ms(records: Sequence) -> Optional[float]:
    """Mean device ms of the ``train/pass`` spans that captured nothing:
    every pass after the warm call's, in whichever mode the replays ran."""
    captured = {r.parent for r in records if r.name == "train/capture"}
    ms = [r.device_ms for r in records
          if r.name == "train/pass" and r.device_ms is not None
          and r.id not in captured]
    return sum(ms) / len(ms) if ms else None


def capture_ms(records: Sequence) -> Optional[float]:
    """Host ms of the ``train/capture/graph`` spans summed (each kind of
    step captured once; their warm-up steps left out)."""
    ns = [r.host_ns for r in records if r.name == "train/capture/graph"]
    return sum(ns) / 1e6 if ns else None


def chunk_issue_ms(records: Sequence) -> Optional[float]:
    """Median host ms of an ``eval/chunk`` span: what the host takes to
    issue a chunk's launches."""
    ns = [r.host_ns for r in records if r.name == "eval/chunk"]
    return statistics.median(ns) / 1e6 if ns else None


def host_idle_ms(trace: DeviceTrace, records: Sequence,
                 chunks: int) -> Optional[float]:
    """Device idle of the trace put down to program spans (gaps the host
    caused, launching the next operation inside one), per chunk."""
    if trace.empty or not chunks or not any(r.name == "eval/chunk"
                                            for r in records):
        return None
    idle = idle_by_span(trace, records)
    return sum(v for k, v in idle.items() if k not in NOT_SPANS) / 1e6 \
        / chunks

"""The device trace of a profiled sub-window and the arithmetic over it.

:func:`record` runs a callable under ``torch.profiler`` (the CUDA
activity alone, CUPTI on the card: recording every host operation as well
slows the host enough to starve the device of an eager loop's launches)
and keeps the profiler's own event list,
never an exported file: a training step launches hundreds of kernels, and a
second of steps is hundreds of thousands of events. The arithmetic is a
frozen copy of ``scripts/torch_serving_profile._trace_stats`` (commit
3ec051a; used by the port's ``torch_eval_profile.py`` and
the other profile scripts): device operations are the trace's device
events, busy time is the union of their intervals, the window runs from
the first host event to the end of the last device operation.

:class:`DeviceTrace` gives the per-layer readers what they need: kernels
grouped into the calls of a wrapper (``SEQUENCE`` of a file under
``portbench/kernels/``), kernels grouped into CUDA-graph replays (the
kernels of one replay share the correlation id of its launch), idle time
between two instants, and the breakdown of the result line.
"""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Callable, Dict, List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Op:
    """One operation on the device: a kernel, a copy or a fill."""

    name: str
    start: int  # ns
    end: int
    stream: int
    corr: int

    @property
    def kernel(self) -> bool:
        return not self.name.startswith(("Memcpy", "Memset"))


@dataclasses.dataclass(frozen=True)
class HostEvent:
    name: str
    start: int
    end: int
    corr: int


def _is_annotation(e) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if flag is not None else False


def record(fn: Callable[[], None]) -> "DeviceTrace":
    """Profile ``fn()`` (which ends in a synchronize) and return its
    trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ops, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            if dur > 0 and not _is_annotation(e):
                ops.append(Op(e.name(), start, start + dur,
                              e.device_resource_id(), e.correlation_id()))
        else:
            host.append(HostEvent(e.name(), start, start + max(dur, 0),
                                  e.correlation_id()))
    return DeviceTrace(ops, host)


class DeviceTrace:
    def __init__(self, ops: List[Op], host: List[HostEvent]):
        self.ops = sorted(ops, key=lambda o: o.start)
        self.host = host
        self.kernels = [o for o in self.ops if o.kernel]
        starts = [h.start for h in host] + [o.start for o in self.ops]
        self.t0 = min(starts) if starts else 0
        self.t1 = max([o.end for o in self.ops] + [h.end for h in host]) \
            if starts else 0
        self._segments = _union(self.ops)
        self._starts = [o.start for o in self.ops]
        self._seg_starts = [seg[0] for seg in self._segments]

    # -- the whole window -------------------------------------------------

    @property
    def empty(self) -> bool:
        return not self.kernels

    @property
    def window_ns(self) -> int:
        return self.t1 - self.t0

    @property
    def busy_ns(self) -> int:
        return sum(e - s for s, e in self._segments)

    @property
    def device_ns(self) -> int:
        """Summed device time of every kernel (not their union)."""
        return sum(o.end - o.start for o in self.kernels)

    # -- wrappers and graph replays ----------------------------------------

    def calls(self, sequence: Sequence[str]) -> List[List[Op]]:
        """Every run of consecutive kernels on one stream whose names
        contain the names of `sequence`, in order: one entry per call of
        the wrapper that launches that sequence."""
        by_stream: Dict[int, List[Op]] = defaultdict(list)
        for o in self.kernels:
            by_stream[o.stream].append(o)
        n, out = len(sequence), []
        for ks in by_stream.values():
            i = 0
            while i + n <= len(ks):
                if all(sequence[j] in ks[i + j].name for j in range(n)):
                    out.append(ks[i:i + n])
                    i += n
                else:
                    i += 1
        return out

    def graph_replays(self, min_kernels: int = 8) -> List[List[Op]]:
        """The kernels of each CUDA-graph replay, by start: the kernels of
        one replay share the correlation id of its launch, an eager launch
        has one kernel of its own."""
        groups: Dict[int, List[Op]] = defaultdict(list)
        for o in self.kernels:
            groups[o.corr].append(o)
        out = [g for c, g in groups.items() if c and len(g) >= min_kernels]
        return sorted(out, key=lambda g: g[0].start)

    def idle_ns(self, a: int, b: int) -> int:
        """Time in ``[a, b]`` in which no operation ran on the device."""
        segs = self._segments
        i = max(0, bisect.bisect_right(self._seg_starts, a) - 1)
        busy = 0
        while i < len(segs) and segs[i][0] < b:
            s, e = segs[i]
            busy += max(0, min(e, b) - max(s, a))
            i += 1
        return max(0, b - a - busy)

    def ops_between(self, a: int, b: int) -> List[Op]:
        """The operations that start and end in ``[a, b]``."""
        lo = bisect.bisect_left(self._starts, a)
        hi = bisect.bisect_right(self._starts, b)
        return [o for o in self.ops[lo:hi] if o.end <= b]

    # -- the breakdown ------------------------------------------------------

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        """The device operations that took most time: ``[name, seconds]``
        summed by name."""
        total: Dict[str, int] = defaultdict(int)
        for o in self.ops:
            total[o.name] += o.end - o.start
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """The idle time between device operations, summed by what the host
        was doing when the operation after each gap was launched: the
        innermost host operation the trace holds around its launch call,
        else that call and the kernel it launched; ``inside a graph
        replay`` where the graph launched it."""
        segs = self._segments
        if not segs:
            return []
        gaps = [(segs[0][0] - self.t0, segs[0][0])] + \
            [(s - pe, s) for (_, pe), (s, _) in zip(segs, segs[1:])]
        first_at = {o.start: o for o in self.ops}
        in_replay = {id(o) for g in self.graph_replays() for o in g[1:]}
        launches = {h.corr: h for h in self.host
                    if h.name.startswith(("cuda", "cu")) and h.corr}
        total: Dict[str, int] = defaultdict(int)
        asks = []  # (launch time, gap length) of gaps an eager launch ends
        for length, end in gaps:
            if length <= 0:
                continue
            op = first_at.get(end)
            call = launches.get(op.corr) if op is not None else None
            if op is None:
                total["unattributed"] += length
            elif id(op) in in_replay:
                total["inside a graph replay"] += length
            elif call is None:
                total["launch of " + op.name[:60]] += length
            else:
                asks.append((call.start, length,
                             f"{call.name} of {op.name[:60]}"))
        for label, length in self._around(asks):
            total[label] += length
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def _around(self, asks):
        """``(label, length)`` per ask: the innermost host operation (not a
        runtime call) open at its launch time, else the launch call and
        the kernel it launched."""
        others = sorted((h for h in self.host
                         if not h.name.startswith(("cuda", "cu"))),
                        key=lambda h: h.start)
        active, i = [], 0
        for t, length, launch in sorted(asks):
            while i < len(others) and others[i].start <= t:
                active.append(others[i])
                i += 1
            active = [h for h in active if h.end >= t]
            inner = max(active, key=lambda h: h.start, default=None)
            yield (inner.name[:80] if inner else launch), length


def _union(ops: List[Op]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for o in ops:  # sorted by start
        if out and o.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], o.end)
        else:
            out.append([o.start, o.end])
    return [(s, e) for s, e in out]

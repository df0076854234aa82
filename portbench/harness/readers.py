"""What a per-layer metric's reader (``portbench/metrics/<name>.py``) is
handed, and the arithmetic several readers share.

A reader is a module with ``UNIT``, ``LAYER`` and ``MOVES`` (as
``BENCHMARK.json`` has them) and ``read(ctx) -> float | None``; None means
it found nothing to read, and the harness leaves the metric out of the
line. It never returns 0 for a share of a roofline or of a peak.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from portbench.harness import flops, manifest
from portbench.harness.trace import DeviceTrace
from portbench.reference.iwae import Widths


@dataclasses.dataclass
class Context:
    #: this rank's trace of the profiled sub-window (rank 0 on a mesh)
    trace: DeviceTrace
    #: work units in the profiled sub-window: ``steps`` of training,
    #: ``batches`` and ``chunks`` (this rank's) of evaluation
    units: dict
    #: the unprofiled window of the same run: ``seconds``, ``rows``, and
    #: ``flops`` (the model's matmul FLOPs of all its work, all chips)
    window: dict
    widths: Widths
    #: ``(k, B)`` of the hot loop's calls in this traffic
    hot_loop_shape: Tuple[int, int]
    chips: int
    card: str

    def per_unit(self, value: float, unit: str) -> Optional[float]:
        n = self.units.get(unit, 0)
        return value / n if n else None


def roofline_share(ctx: Context, kernel_name: str) -> Optional[float]:
    """The calls of a kernel in the trace, as % of their least time: the
    larger of operations over the bf16 peak and bytes over HBM bandwidth,
    at the traffic's call shape, against the device time of the kernels
    each call launched. None where the trace holds no call."""
    spec = manifest.kernel(kernel_name)
    calls = ctx.trace.calls(spec.SEQUENCE)
    peak_f, peak_b = flops.peak_flops(ctx.card), flops.peak_bytes(ctx.card)
    if not calls or peak_f is None:
        return None
    k, b = ctx.hot_loop_shape
    w = ctx.widths
    ops, nbytes = spec.work(k, b, w.enc[0][1], w.out_hidden, w.x_dim)
    least = max(ops / peak_f, nbytes / peak_b) * len(calls)
    spent = sum(o.end - o.start for call in calls for o in call) / 1e9
    return 100.0 * least / spent


def mfu(ctx: Context) -> Optional[float]:
    """The window's matmul FLOPs over its seconds and the bf16 peak of
    every chip it used, in %."""
    peak = flops.peak_flops(ctx.card)
    if peak is None or not ctx.window.get("seconds"):
        return None
    return 100.0 * ctx.window["flops"] / (ctx.window["seconds"] * peak
                                          * ctx.chips)


def idle_share(ctx: Context) -> Optional[float]:
    if ctx.trace.empty:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_ns / ctx.trace.window_ns)


def read_all(entries, ctx: Context) -> dict:
    """``{name: (value, unit)}`` of the per-layer metrics `entries` whose
    readers found something to read."""
    out = {}
    for m in entries:
        value = manifest.metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = (value, m["unit"])
    return out

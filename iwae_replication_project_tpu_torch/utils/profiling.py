"""Tracing, timing and debugging helpers (port of ``utils/profiling.py``).

* :func:`trace` -- a ``torch.profiler`` trace of everything run inside,
  written as Chrome trace-event JSON into ``logdir`` (host ranges, the
  ``span/*`` names of ``telemetry/spans.py``, and on the card each kernel);
* :class:`StepTimer` -- wall-clock stats of repeated steps on the registry's
  :class:`~..telemetry.registry.Histogram`, with the JAX module's summary
  schema;
* :func:`nan_guard` -- raise at the first op whose floating output is not
  finite, naming the op (torch has no ``jax_debug_nans``: a
  ``TorchDispatchMode`` checks every output, and
  ``torch.autograd.set_detect_anomaly`` covers the backward). Each check
  syncs with the device: debugging only, and refused inside a CUDA-graph
  capture;
* :func:`assert_finite_tree` -- an all-finite check over a parameter tree.

Nothing here imports beyond torch and the standard library.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
import types
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from iwae_replication_project_tpu_torch.telemetry.registry import Histogram
from iwae_replication_project_tpu_torch.utils.tree import tree_leaves

_trace_seq = itertools.count()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the host and, when there is one, the card; on exit write the
    Chrome trace to ``<logdir>/trace-<pid>-<n>.json``. Yields a namespace
    whose ``path`` names that file."""
    os.makedirs(logdir, exist_ok=True)
    out = types.SimpleNamespace(path=os.path.join(
        logdir, f"trace-{os.getpid()}-{next(_trace_seq)}.json"))
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield out
    prof.export_chrome_trace(out.path)


class _NonFiniteCheck(TorchDispatchMode):
    """Runs every op, then raises ``FloatingPointError`` naming the first
    whose floating output holds a NaN or an infinity."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out if isinstance(out, (tuple, list))
                             else [out]):
            if isinstance(t, torch.Tensor) and t.is_floating_point() \
                    and t.numel() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"nan_guard: {func} produced a non-finite value "
                    f"(output of shape {tuple(t.shape)})")
        return out


@contextlib.contextmanager
def nan_guard(enable: bool = True):
    """Raise at the first op inside the context whose floating output is
    not finite (forward ops by the dispatch mode, the backward by autograd's
    anomaly detection). Syncs per op: debugging only, never in the hot loop
    and never inside a CUDA-graph capture, where it refuses to start."""
    if not enable:
        yield
        return
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("nan_guard syncs with the device at every op; it "
                           "cannot run inside a CUDA-graph capture")
    with torch.autograd.set_detect_anomaly(True), _NonFiniteCheck():
        yield


def assert_finite_tree(tree, label: str = "tree") -> None:
    """Raise AssertionError naming `label` if any tensor leaf has a NaN or
    an infinity."""
    for i, leaf in enumerate(tree_leaves(tree)):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point() \
                and not bool(torch.isfinite(leaf).all()):
            raise AssertionError(
                f"non-finite values in {label}: leaf {i} of shape "
                f"{tuple(leaf.shape)}")


class StepTimer:
    """Wall-clock timing of repeated steps, cheap enough to leave on: a
    context-manager view over the registry's log-spaced histogram (O(1) per
    step, ~one-bin quantile resolution, exact max). ``sync_fn`` (e.g.
    ``torch.cuda.synchronize``) runs before each step's clock stops."""

    def __init__(self, sync_fn=None):
        self._sync = sync_fn
        self._hist = Histogram()
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            self._sync()
        self._hist.record(time.perf_counter() - self._t0)
        self._t0 = None
        return False

    @property
    def count(self) -> int:
        return self._hist.n

    def summary(self) -> Dict[str, float]:
        s = self._hist.summary()
        if not s["count"]:
            return {"count": 0}
        return {
            "count": s["count"],
            "total_s": self._hist.total,
            "mean_s": s["mean"],
            "p50_s": s["p50"],
            "p95_s": s["p95"],
            "max_s": s["max"],
        }

    def reset(self):
        self._hist = Histogram()


__all__ = ["StepTimer", "assert_finite_tree", "nan_guard", "trace"]

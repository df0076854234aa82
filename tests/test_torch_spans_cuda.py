"""The span recorder on the card: its records and a CUDA-only
``torch.profiler`` trace of the same process share a clock, and the
serving profiler times a replay alone.

* every ``train/replay`` span holds exactly one ``cudaGraphLaunch`` runtime
  call, the one whose correlation id the replay's kernels carry;
* every launch of a streamed NLL batch lies inside its ``eval/batch`` span
  and, after its first chunk began, inside an ``eval/chunk`` or
  ``eval/finalize`` span; the idle put down to spans and to the labels of
  none sums to the trace's idle time;
* a ``train/pass`` span's device ms agrees within 1% with CUDA events
  recorded between the epoch calls, as the benchmark's harness records
  them;
* the ``DispatchProfiler``'s device interval of a served batch lies within
  20 us of its replay's operations in the trace (medians of 16).

The trace is the benchmark's (``portbench/harness/trace.record``: CUDA
activity alone). Every test needs an NVIDIA GPU (marker ``cuda``) and skips
without one. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from iwae_replication_project_tpu_torch.evaluation.metrics import (
    streaming_log_px,
)
from iwae_replication_project_tpu_torch.models import iwae as model
from iwae_replication_project_tpu_torch.objectives import ObjectiveSpec
from iwae_replication_project_tpu_torch.serving.engine import ServingEngine
from iwae_replication_project_tpu_torch.telemetry import spans
from iwae_replication_project_tpu_torch.telemetry.diagnostics import (
    DiagnosticsConfig,
)
from iwae_replication_project_tpu_torch.training import epoch as tepoch
from iwae_replication_project_tpu_torch.training import train_step as ts
from iwae_replication_project_tpu_torch.utils.config import ExperimentConfig

N_TRAIN, BATCH, K = 2000, 100, 50


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans' CUDA events, the "
                    "device trace and CUDA graphs have no CPU mode (the "
                    "recorder's host side is tested in test_torch_spans.py)")
    return torch.device("cuda")


@pytest.fixture
def trace_mod():
    from portbench.harness import trace
    return trace


def _training(cuda, n_train=N_TRAIN):
    cfg = ExperimentConfig().model_config("cuda")
    epoch = tepoch.make_epoch_fn(ObjectiveSpec(name="IWAE", k=K), cfg,
                                 n_train, BATCH,
                                 diagnostics=DiagnosticsConfig(snr_window=5))
    x = (torch.rand((n_train, 784), generator=torch.Generator()
                    .manual_seed(0)) > 0.5).float().to(cuda)
    return epoch, ts.create_train_state(0, cfg), x


def _inside(h, r) -> bool:
    return r.t_start_ns <= h.start and h.end <= r.t_end_ns


@pytest.mark.cuda
def test_every_replay_span_holds_its_graph_launch(cuda, trace_mod):
    epoch, state, x = _training(cuda)
    with spans.recording():
        state, _ = epoch(state, x)          # the warm call: captures

        def calls():
            nonlocal state
            for _ in range(2):
                state, _ = epoch(state, x)
        tr = trace_mod.record(calls)
    d = spans.drain()
    replays = [r for r in d.named("train/replay")
               if tr.t0 <= r.t_start_ns <= tr.t1]
    groups = tr.graph_replays()
    assert len(replays) == len(groups) == 2 * (N_TRAIN // BATCH)
    owners = {g[0].corr for g in groups}
    graph_launches = [h for h in tr.host
                      if h.name.startswith("cudaGraphLaunch")]
    for r in replays:
        inside = [h for h in graph_launches if _inside(h, r)]
        assert len(inside) == 1, (r, inside)
        assert inside[0].corr in owners
    assert d.counts["train/replays"] >= len(replays)
    assert d.counts["train/captures"] == 2 and d.dropped == 0


@pytest.mark.cuda
def test_eval_launches_lie_inside_chunk_spans(cuda, trace_mod):
    from portbench.harness import spans as readings

    cfg = ExperimentConfig().model_config("cuda")
    params = model.to_device(model.init_params(
        torch.Generator().manual_seed(0), cfg), cuda)
    x = (torch.rand((100, 784), generator=torch.Generator().manual_seed(1))
         > 0.5).float().to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    streaming_log_px(params, cfg, x, 1000, 250, generator=gen)  # warm
    with spans.recording():
        tr = trace_mod.record(lambda: [streaming_log_px(
            params, cfg, x, 1000, 250, generator=gen) for _ in range(3)])
    recs = spans.drain().records
    batches = [r for r in recs if r.name == "eval/batch"]
    chunks = [r for r in recs if r.name == "eval/chunk"]
    held = chunks + [r for r in recs if r.name == "eval/finalize"]
    assert len(batches) == 3 and len(chunks) == 12
    ops = {o.corr for o in tr.ops}
    launches = [h for h in tr.host if h.corr in ops]
    assert launches
    first = {r.attrs["batch"]: r.t_start_ns for r in chunks
             if r.attrs["chunk"] == 0}
    for h in launches:
        b, = [b for b in batches if _inside(h, b)]
        # before the first chunk, the batch makes its carry alone
        assert h.start < first[b.attrs["batch"]] or \
            any(_inside(h, r) for r in held), h
    idle = readings.idle_by_span(tr, recs)
    assert sum(idle.values()) == tr.window_ns - tr.busy_ns


@pytest.mark.cuda
def test_pass_device_ms_agrees_with_events_between_calls(cuda):
    """At the benchmark's pass of 500 steps: the events between calls also
    hold the call's SNR summary and loss clone (a few ms)."""
    epoch, state, x = _training(cuda, n_train=50_000)
    state, _ = epoch(state, x)
    marks = [torch.cuda.Event(enable_timing=True)]
    marks[0].record()
    with spans.recording():
        for _ in range(4):
            state, _ = epoch(state, x)
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
    torch.cuda.synchronize()
    passes = spans.drain().named("train/pass")
    calls = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    assert len(passes) == len(calls) == 4
    for p, c in zip(passes, calls):
        assert abs(p.device_ms - c) <= 0.01 * c, (p.device_ms, c)


@pytest.mark.cuda
def test_dispatch_profiler_times_the_replay_alone(cuda, trace_mod):
    """The profiler's intervals of untraced dispatches against the
    operations of traced ones' replays (a trace slows the replays)."""
    cfg = ExperimentConfig().model_config("cuda")
    params = model.to_device(model.init_params(
        torch.Generator().manual_seed(0), cfg), cuda)
    eng = ServingEngine(params=params, model_config=cfg, k=K,
                        timeout_s=None)
    rows = (np.random.RandomState(0).rand(5, 784) > 0.5).astype(np.float32)
    eng.score(rows)                         # the capture
    seen = []
    observe = eng.profiler.observe

    def keep(**kw):
        seen.append(kw["device_s"] * 1e9)
        return observe(**kw)
    eng.profiler.observe = keep
    for _ in range(16):
        eng.score(rows)
    untraced = sorted(seen)
    tr = trace_mod.record(lambda: [eng.score(rows) for _ in range(16)])
    groups = tr.graph_replays()
    assert len(groups) == 16 and len(seen) == 32
    # a replay's operations: its kernels and its copies and fills
    replays = [[o for o in tr.ops if o.corr == g[0].corr] for g in groups]
    spans_ns = sorted(max(o.end for o in r) - min(o.start for o in r)
                      for r in replays)
    mid, r_mid = untraced[8], spans_ns[8]
    assert 0.9 * r_mid <= mid <= r_mid + 20_000, (
        untraced, spans_ns, sorted(seen[16:]),
        [(o.name[:40], o.start - replays[0][0].start) for o in replays[0]
         if not o.kernel])

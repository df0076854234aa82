"""The port's span recorder (``telemetry/spans.py``) on the CPU: off it
records nothing and leaves the ``span()`` histograms as they were; on it
nests, links parents, bounds its buffer and stamps the clock of the
profiler's host events; the program's sites (``training/epoch.py``,
``ops/logsumexp.streaming_logmeanexp``) record without changing a bit of
what they compute; the serving store times the program alone between the
profiler's events. Its device side (CUDA events, the clock against a
CUDA-only trace) is tested on the card in ``test_torch_spans_cuda.py``."""

import contextlib
import threading

import pytest
import torch

from iwae_replication_project_tpu_torch.evaluation.metrics import (
    streaming_log_px,
)
from iwae_replication_project_tpu_torch.models import iwae as model
from iwae_replication_project_tpu_torch.objectives import ObjectiveSpec
from iwae_replication_project_tpu_torch.telemetry import registry as treg
from iwae_replication_project_tpu_torch.telemetry import spans
from iwae_replication_project_tpu_torch.telemetry.diagnostics import (
    DiagnosticsConfig,
)
from iwae_replication_project_tpu_torch.training import epoch as tepoch
from iwae_replication_project_tpu_torch.training import train_step as ts
from iwae_replication_project_tpu_torch.utils import compile_cache as tcc

TINY = dict(n_hidden_enc=(16, 8), n_latent_enc=(4, 2), n_hidden_dec=(8, 16),
            n_latent_dec=(4, 784))


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.stop()
    spans.drain()
    yield
    spans.stop()
    spans.drain()


def _nest(reg):
    with spans.span("a", registry=reg):
        with spans.span("b", registry=reg):
            pass
        with spans.span("c", registry=reg):
            pass


def _hist_counts(reg):
    return {k: v["count"] for k, v in reg.snapshot()["histograms"].items()}


def test_off_records_nothing_and_histograms_are_the_same():
    off, on = treg.MetricRegistry(), treg.MetricRegistry()
    _nest(off)
    assert spans.drain().records == []
    with spans.recording():
        _nest(on)
    assert _hist_counts(off) == _hist_counts(on) == {
        "span/a": 1, "span/a/b": 1, "span/a/c": 1}
    assert [r.name for r in spans.drain().records] == ["a", "b", "c"]


def test_records_nest_by_parent_id():
    with spans.recording():
        _nest(treg.MetricRegistry())
        sp = spans.REC.begin("d", {"pass": 3})
        spans.REC.end(sp)
    a, b, c, d = spans.drain().records
    assert a.parent is None and b.parent == c.parent == a.id
    assert d.parent is None and d.attrs == {"pass": 3}
    assert len({a.id, b.id, c.id, d.id}) == 4
    assert a.t_start_ns <= b.t_start_ns <= b.t_end_ns <= c.t_start_ns \
        <= c.t_end_ns <= a.t_end_ns
    assert all(r.device_ms is None for r in (a, b, c, d))
    assert a.thread == threading.get_ident()


def test_self_time_leaves_out_the_children():
    from portbench.harness.spans import self_ns

    with spans.recording():
        _nest(treg.MetricRegistry())
    a, b, c = spans.drain().records
    own = self_ns([a, b, c])
    assert own[b.id] == b.host_ns and own[c.id] == c.host_ns
    assert own[a.id] == a.host_ns - b.host_ns - c.host_ns


def test_a_full_buffer_counts_what_it_drops():
    with spans.recording(capacity=2):
        outer = spans.REC.begin("outer")
        for _ in range(3):
            with spans.REC.section("inner"):
                pass
        spans.REC.end(outer)
    d = spans.drain()
    assert [r.name for r in d.records] == ["outer", "inner"]
    assert d.dropped == 2
    assert d.records[1].parent == d.records[0].id
    with pytest.raises(ValueError):
        spans.start(0)


def test_drain_empties_and_recording_goes_on():
    spans.start()
    with spans.REC.section("x"):
        spans.REC.count("n", 2)
    first = spans.drain()
    with spans.REC.section("y"):
        spans.REC.count("n")
    spans.stop()
    with spans.REC.section("z"):
        pass
    second = spans.drain()
    assert [r.name for r in first.records] == ["x"] and first.counts == {
        "n": 2}
    assert [r.name for r in second.records] == ["y"] and second.counts == {
        "n": 1}
    assert spans.drain().records == []


def test_an_open_span_is_left_out_and_an_exception_closes_its_span():
    with spans.recording():
        spans.REC.begin("never closed")
        with pytest.raises(ValueError):
            with spans.REC.section("raises"):
                raise ValueError("closed all the same")
        with spans.REC.section("after"):
            pass
    names = {r.name: r for r in spans.drain().records}
    assert set(names) == {"raises", "after"}
    assert names["after"].parent is not None  # the open span holds it


def test_threads_record_their_own_parents():
    both = threading.Barrier(2)

    def work(name):
        with spans.REC.section(name):
            both.wait()
            with spans.REC.section(name + "/child"):
                both.wait()
    with spans.recording():
        threads = [threading.Thread(target=work, args=(n,)) for n in "xy"]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    recs = {r.name: r for r in spans.drain().records}
    for n in "xy":
        assert recs[n + "/child"].parent == recs[n].id
        assert recs[n].parent is None
    assert recs["x"].thread != recs["y"].thread


def test_off_a_timed_span_still_returns_its_seconds():
    sp = spans.REC.begin("train/capture")
    assert spans.REC.end(sp) >= 0.0
    assert spans.drain().records == []


def test_the_stamps_bracket_the_profilers_range():
    """The clock check: a span's ``time_ns`` stamps hold the
    ``record_function`` range of the same span in a CPU profile."""
    from torch.profiler import ProfilerActivity, profile

    with spans.recording():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with spans.span("clock/check", registry=treg.MetricRegistry()):
                torch.ones(64) @ torch.ones(64)
    rec, = spans.drain().records
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "clock/check"]
    assert len(ev) == 1
    start, end = ev[0].start_ns(), ev[0].start_ns() + ev[0].duration_ns()
    assert rec.t_start_ns <= start <= end <= rec.t_end_ns


def _epoch_losses(record: bool):
    cfg = model.ModelConfig.two_layer(**TINY)
    fn = tepoch.make_epoch_fn(ObjectiveSpec(name="IWAE", k=3), cfg, 40, 10,
                              diagnostics=DiagnosticsConfig(snr_window=2),
                              epochs_per_call=2)
    state = ts.create_train_state(0, cfg, device="cpu")
    x = (torch.rand((40, 784), generator=torch.Generator().manual_seed(0))
         > 0.5).float()
    with spans.recording() if record else contextlib.nullcontext():
        state, (losses, snr) = fn(state, x)
    return losses, snr, spans.drain()


def test_epoch_losses_are_bitwise_the_same_recorded():
    a, snr_a, none = _epoch_losses(False)
    b, snr_b, d = _epoch_losses(True)
    assert torch.equal(a, b)
    assert all(torch.equal(snr_a[k], snr_b[k]) for k in snr_a)
    assert none.records == []
    passes = d.named("train/pass")
    assert [p.attrs["pass"] for p in passes] == [0, 1]
    assert len(d.named("train/shuffle")) == 2
    assert len(d.named("train/snr_summary")) == 1
    assert len(d.named("train/loss_clone")) == 1
    assert d.counts == {"train/eager_steps": 8}
    epoch_span, = d.named("train/epoch_block")
    assert {p.parent for p in passes} == {epoch_span.id}
    encodes = d.named("model/encode")
    assert len(encodes) == 8
    assert {e.parent for e in encodes} <= {p.id for p in passes}


def test_streamed_rows_are_bitwise_the_same_recorded():
    cfg = model.ModelConfig.two_layer(**TINY)
    params = model.init_params(torch.Generator().manual_seed(0), cfg)
    x = (torch.rand((6, 784), generator=torch.Generator().manual_seed(1))
         > 0.5).float()
    a = streaming_log_px(params, cfg, x, 12, 4,
                         generator=torch.Generator().manual_seed(2))
    with spans.recording():
        b = streaming_log_px(params, cfg, x, 12, 4,
                             generator=torch.Generator().manual_seed(2))
        streaming_log_px(params, cfg, x, 8, 4,
                         generator=torch.Generator().manual_seed(3))
    d = spans.drain()
    assert torch.equal(a, b)
    chunks = d.named("eval/chunk")
    assert [(c.attrs["batch"], c.attrs["chunk"]) for c in chunks] == [
        (0, 0), (0, 1), (0, 2), (1, 0), (1, 1)]
    assert d.counts == {"eval/chunks": 5}
    assert len(d.named("eval/finalize")) == 2
    assert [b.attrs["batch"] for b in d.named("eval/batch")] == [0, 1]
    by_id = {r.id: r for r in d.records}
    assert {by_id[c.parent].name for c in chunks} == {"eval/batch"}
    for name, parent in (("eval/log_weights", "eval/chunk"),
                         ("eval/lse_update", "eval/chunk"),
                         ("model/encode", "eval/log_weights"),
                         ("model/decode", "eval/log_weights")):
        kids = d.named(name)
        assert len(kids) == 5
        assert {by_id[k.parent].name for k in kids} == {parent}


class _Event:
    def __init__(self, log):
        self.log = log

    def record(self, stream=None):
        self.log.append(self)


def test_the_store_times_the_program_alone():
    """The serving profiler's events bracket the program's call inside the
    store: the resolve, the fault point and the span stay outside."""
    log = []
    start, end = _Event(log), _Event(log)

    def program(t):
        log.append("program")
        return t + 1
    with tcc.isolated_aot_registry(budget_bytes=None):
        out, hit = tcc.aot_call_async("f", program, (torch.zeros(3),),
                                      events=(start, end))
    assert log == [start, "program", end]
    assert torch.equal(out, torch.ones(3)) and not hit

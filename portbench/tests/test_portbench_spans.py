"""``harness/spans.py`` on a synthetic device trace and span records: self
time, idle put down to the span that launched the operation after each
gap, the table, and the four readings (None without records)."""

from __future__ import annotations

from iwae_replication_project_tpu_torch.telemetry.spans import SpanRecord
from portbench.harness import spans as sp
from portbench.harness.trace import DeviceTrace, HostEvent, Op

MS = 1_000_000


def rec(name, id_, t0, t1, parent=None, device_ms=None, **attrs):
    return SpanRecord(name, id_, parent, 1, t0, t1, attrs, device_ms)


def eager_trace():
    """Three eager kernels after idle gaps of 2, 1 and 4 ms; their launch
    calls at 1, 5.5 and 8 ms; the window ends 1 ms after the last kernel
    (a synchronize)."""
    ops = [Op("k0", 3 * MS, 5 * MS, 7, 11), Op("k1", 6 * MS, 9 * MS, 7, 12),
           Op("k2", 13 * MS, 14 * MS, 7, 13)]
    host = [HostEvent("cudaLaunchKernel", 1 * MS, 1 * MS + 10, 11),
            HostEvent("cudaLaunchKernel", 5 * MS + 500_000, 5 * MS + 500_010,
                      12),
            HostEvent("cudaLaunchKernel", 8 * MS, 8 * MS + 10, 13),
            HostEvent("cudaDeviceSynchronize", 12 * MS, 15 * MS, 0)]
    return DeviceTrace(ops, host)


def eval_records():
    return [rec("eval/chunk", 1, 0, 7 * MS, chunk=0),
            rec("eval/log_weights", 2, 0, 4 * MS, parent=1),
            rec("eval/lse_update", 3, 5 * MS, 5 * MS + 400_000, parent=1),
            rec("eval/chunk", 4, 7 * MS + 1, 9 * MS, chunk=1)]


def test_self_time_subtracts_the_children():
    own = sp.self_ns(eval_records())
    assert own[1] == 7 * MS - 4 * MS - 400_000
    assert own[2] == 4 * MS and own[4] == 2 * MS - 1


def test_idle_goes_to_the_innermost_span_at_each_launch():
    tr = eager_trace()
    gaps = sp.idle_gaps(tr, eval_records())
    # k0's gap from the window's start (1 ms, its launch call) to 3 ms: the
    # launch at 1 ms lies in eval/log_weights; k1's (5-6 ms) was launched at
    # 5.5 ms, after the device went idle, inside eval/chunk 0 alone; k2's
    # (9-13 ms) at 8 ms, before it: queued; then 1 ms after the last kernel
    assert gaps == [("eval/log_weights", 2 * MS), ("eval/chunk", 1 * MS),
                    (sp.QUEUED, 4 * MS), (sp.TAIL, 1 * MS)]
    assert sum(g for _, g in gaps) == tr.window_ns - tr.busy_ns
    assert sp.idle_by_span(tr, []) == {sp.NO_SPAN: 3 * MS, sp.QUEUED: 4 * MS,
                                       sp.TAIL: 1 * MS}


def test_replays_queued_work_and_missing_launches_have_labels():
    ops = [Op(f"k{i}", (2 * i + 1) * MS, (2 * i + 2) * MS, 7, 50)
           for i in range(8)] + [Op("memcpy?", 20 * MS, 21 * MS, 7, 0),
                                 Op("late", 23 * MS, 24 * MS, 7, 51),
                                 Op("early", 26 * MS, 27 * MS, 7, 52)]
    host = [HostEvent("cudaGraphLaunch", 0, 10, 50),
            HostEvent("cudaLaunchKernel", 22 * MS, 22 * MS + 10, 51),
            HostEvent("cudaLaunchKernel", 23 * MS + 500_000,
                      23 * MS + 500_010, 52)]
    tr = DeviceTrace(ops, host)
    idle = sp.idle_by_span(tr, [rec("train/replay", 1, 0, 20),
                                rec("train/snr_summary", 2, 21 * MS,
                                    26 * MS)])
    # the graph launch came before the device went idle at 0: nothing to
    # wait for but the launch; "late" was launched at 22 ms, after the
    # device went idle at 21; "early" at 23.5 ms, before it went idle at 24
    assert idle == {"train/replay": 1 * MS, sp.IN_REPLAY: 7 * MS,
                    sp.NO_LAUNCH: 4 * MS, "train/snr_summary": 2 * MS,
                    sp.QUEUED: 2 * MS}
    assert sum(idle.values()) == tr.window_ns - tr.busy_ns


def test_the_table_names_every_span_and_label():
    tr = eager_trace()
    recs = eval_records()
    lines = sp.table(recs, sp.idle_by_span(tr, recs))
    assert lines[0].split()[0] == "span"
    first = {line.split()[0] for line in lines[1:]}
    assert {"eval/chunk", "eval/log_weights", "eval/lse_update"} <= first
    chunk = next(line for line in lines if line.startswith("eval/chunk"))
    assert chunk.split()[1] == "2" and chunk.split()[-1] == "1.000"
    assert any(line.startswith(sp.TAIL) for line in lines)


def test_pass_device_ms_leaves_out_the_pass_that_captured():
    recs = [rec("train/pass", 1, 0, 10, device_ms=900.0),
            rec("train/capture", 2, 1, 5, parent=1),
            rec("train/capture/graph", 3, 2, 2 + 40 * MS, parent=2),
            rec("train/pass", 4, 11, 20, device_ms=800.0),
            rec("train/pass", 5, 21, 30, device_ms=720.0)]
    assert sp.pass_device_ms(recs) == 760.0
    assert sp.capture_ms(recs) == 40.0
    assert sp.pass_device_ms(recs[1:3]) is None
    assert sp.pass_device_ms([]) is None and sp.capture_ms([]) is None


def test_chunk_issue_ms_is_the_median_host_time_of_a_chunk():
    recs = [rec("eval/chunk", i, 0, d * MS) for i, d in enumerate((1, 3, 2))]
    assert sp.chunk_issue_ms(recs) == 2.0
    assert sp.chunk_issue_ms([]) is None


def test_host_idle_ms_counts_the_spans_share_per_chunk():
    tr = eager_trace()
    assert sp.host_idle_ms(tr, eval_records(), chunks=2) == 1.5
    assert sp.host_idle_ms(tr, [], chunks=2) is None
    assert sp.host_idle_ms(DeviceTrace([], []), eval_records(), 2) is None
    assert sp.host_idle_ms(tr, eval_records(), chunks=0) is None


def test_the_profile_script_reads_a_dry_eval_cell(capsys):
    """``scripts/torch_spans_profile.py`` over the eval cell's CPU dry run:
    the harness's line, then the recorder's counts and readings."""
    import importlib.util
    import json
    from pathlib import Path

    from portbench.tests.conftest import DRY

    path = Path(__file__).resolve().parents[2] / "scripts" / \
        "torch_spans_profile.py"
    spec = importlib.util.spec_from_file_location("spans_profile", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    dry = json.dumps({"traffic": dict(DRY["iwae2l-eval"], n_test=20,
                                      check_batches=1)})
    code = script.main(["--record", "1", "--dry", dry, "--",
                        "--workload", "iwae2l-eval", "--seed", "2147483659",
                        "--seconds", "0.1", "--trace", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert code == 0 and json.loads(lines[-2])["correct"] is True
    out = json.loads(lines[-1])
    assert out["counts"]["eval/chunks"] > 0 and out["dropped"] == 0
    assert out["readings"]["chunk_issue_ms"] > 0
    assert out["readings"]["pass_device_ms"] is None

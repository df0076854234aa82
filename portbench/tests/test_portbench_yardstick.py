"""The frozen arithmetic of the benchmark: FLOP counts, kernel work
counts, the trace arithmetic, the seeds and the inputs."""

from __future__ import annotations

import pytest
import torch

from portbench.harness import compare, flops, inputs, manifest, trace
from portbench.reference.iwae import Widths

TWO = Widths.from_config(manifest.config(manifest.load(), "iwae-2l-k50"))
ONE = Widths.from_config(manifest.config(manifest.load(), "iwae-1l-k50"))


@pytest.mark.parametrize("widths, gflop", [(TWO, 8.596), (ONE, 6.334)])
def test_train_step_flops(widths, gflop):
    assert flops.train_step_flops(widths, 100, 50) / 1e9 == \
        pytest.approx(gflop, abs=5e-4)


def test_k5000_row_flops_and_params():
    assert flops.forward_flops(TWO, 1, 5000) / 1e9 == \
        pytest.approx(2.818, abs=5e-4)
    assert (flops.param_count(TWO), flops.param_count(ONE)) == \
        (521084, 425284)


def test_peaks_name_only_the_h100_sxm():
    assert flops.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert flops.peak_bytes("NVIDIA H100 80GB HBM3") == 3.35e12
    assert flops.peak_flops("NVIDIA H100 PCIe") is None


@pytest.mark.parametrize("name, k, b, least_ms", [
    ("hot_loop_fwd", 50, 100, 0.00219), ("hot_loop_fwd", 250, 500, 0.05480),
    ("hot_loop_bwd", 50, 100, 0.00658), ("hot_loop_bwd", 250, 500, 0.16441)])
def test_kernel_work_gives_the_bounds_of_the_kernel_table(name, k, b,
                                                          least_ms):
    ops, nbytes = manifest.kernel(name).work(k, b, 100, 200, 784)
    least = max(ops / flops.PEAK_BF16_FLOPS, nbytes / flops.PEAK_HBM_BYTES)
    assert least * 1e3 == pytest.approx(least_ms, abs=1e-5)


def _op(name, s, e, corr=0, stream=7):
    return trace.Op(name, s, e, stream, corr)


def test_trace_arithmetic():
    ops = [_op("prep_weights", 0, 10, 1), _op("hot_loop_fwd_tc", 10, 30, 1),
           _op("add", 50, 60, 2), _op("prep_weights", 100, 110, 3),
           _op("hot_loop_fwd_tc", 110, 140, 3)]
    tr = trace.DeviceTrace(ops, [trace.HostEvent("aten::add", 0, 5, 9)])
    assert tr.window_ns == 140 and tr.busy_ns == 30 + 10 + 40
    assert len(tr.calls(("prep_weights", "hot_loop_fwd_tc"))) == 2
    assert tr.idle_ns(30, 100) == 60
    assert tr.top_ops(1) == [["hot_loop_fwd_tc", 50 / 1e9]]
    assert sum(v for _, v in tr.idle_gaps()) == pytest.approx(60 / 1e9)


def test_graph_replays_are_kernels_sharing_a_launch():
    ops = [_op(f"k{i}", 10 * i, 10 * i + 5, corr=1) for i in range(8)] + \
        [_op("randperm", 90, 95, corr=2)] + \
        [_op(f"k{i}", 100 + 10 * i, 105 + 10 * i, corr=3) for i in range(8)]
    tr = trace.DeviceTrace(ops, [])
    replays = tr.graph_replays()
    assert [len(r) for r in replays] == [8, 8]
    assert tr.ops_between(replays[0][-1].end, replays[1][0].start)[0].name \
        == "randperm"


def test_sub_seeds_take_any_seed_and_differ_by_label():
    a = inputs.sub_seed(2 ** 31 + 12345, "data")
    assert 0 <= a < 2 ** 63
    assert a != inputs.sub_seed(2 ** 31 + 12345, "weights")
    assert a == inputs.sub_seed(2 ** 31 + 12345, "data")


def test_inputs_repeat_from_the_seed():
    x1, = inputs.synthetic_rows(5, (64,), "cpu")
    x2, = inputs.synthetic_rows(5, (64,), "cpu")
    assert torch.equal(x1, x2) and set(x1.unique().tolist()) <= {0.0, 1.0}
    w = inputs.init_weights(5, ONE, x1)
    tree = inputs.program_tree(w, ONE)
    assert tree["enc"][0]["l1"]["w"] is w["enc0.l1.w"]
    assert tree["out"]["out"]["b"] is w["out.out.b"]
    assert sum(t.numel() for t in w.values()) == flops.param_count(ONE)


def test_leaf_gaps_take_the_worst_leaf_against_the_median():
    ref = {"a": torch.ones(4), "b": torch.full((4,), 2.0),
           "c": torch.full((4,), 1e-9)}
    prog = {"a": torch.ones(4), "b": torch.full((4,), 2.2),
            "c": torch.full((4,), 2e-9)}
    # c's gap is measured against the median leaf's norm (a's, 2.0)
    assert compare.leaf_norm_gap(prog, ref) == pytest.approx(0.1)
    assert compare.quiet_leaves(ref) == {"c"}
    assert compare.loss_gap([101.0], [100.0]) == pytest.approx(0.01)

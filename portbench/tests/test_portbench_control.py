"""The control of each cell's comparison: the reference put in the
program's place with its matmul operands in fp8, one precision below the
configuration's bf16, must come out not correct, and the program must not.
On the CPU at a size a test can hold (full widths, few rows and samples);
on the card at the cell's own size over three seeds
(``portbench/calibrate.py``, the same readings the limits were set
from)."""

from __future__ import annotations

import pytest
import torch

from portbench import calibrate
from portbench.harness import manifest
from portbench.tests.conftest import DRY, load_run

ONE_CARD = ["iwae2l-train", "iwae1l-train", "iwae2l-eval"]
CELLS = [w["name"] for w in manifest.load()["workloads"]]


def _cell(workload, dry):
    run = load_run()
    return run.make_cell(run.parse(["--workload", workload, "--seed", "0",
                                    "--seconds", "0"]), dry=dry)


def _fails(reading: dict, limits: dict) -> bool:
    return any(reading[n] > limits[n] for n in limits)


def _readings(cell, seed, dev):
    kind = cell.traffic["kind"]
    fn = calibrate.train_readings if kind == "train_pass" \
        else calibrate.eval_readings
    return fn(cell, seed, dev)


@pytest.mark.parametrize("workload", ONE_CARD)
def test_control_fails_and_program_passes_on_the_cpu(workload):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cell = _cell(workload, {"traffic": DRY[workload]})
        got = _readings(cell, 2147483671, torch.device("cpu"))
    finally:
        torch.set_num_threads(threads)
    assert _fails(got["control"], cell.limits)
    assert not _fails(got["program"], cell.limits)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_and_faults_fail_at_the_cells_size_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control at the cell's own size")
    cell = _cell(workload, None)
    from portbench.harness import program
    program.prepare(cell)
    for seed in (2147483681, 2147483682, 2147483683):
        got = _readings(cell, seed, torch.device("cuda"))
        assert _fails(got["control"], cell.limits), seed
        for fault in set(got) - {"program", "control"}:
            assert _fails(got[fault], cell.limits), (seed, fault)
        if "program" in got:
            assert not _fails(got["program"], cell.limits), seed

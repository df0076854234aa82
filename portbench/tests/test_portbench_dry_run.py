"""Each cell's tiny run on the CPU (full widths, few rows and samples):
one last line with the result's keys, the checks last, and the metrics of
the cell's kind."""

from __future__ import annotations

import pytest

from portbench.harness import manifest
from portbench.tests.conftest import SP4

CELLS = [w["name"] for w in manifest.load()["workloads"]]
REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_dry_run_prints_one_result_line(dry_run, cell, trace):
    code, line = dry_run(cell, trace=trace)
    assert code == 0
    assert list(line)[:5] == REQUIRED and list(line)[-1] == "checks"
    assert set(line) <= set(REQUIRED) | {"breakdown", "checks"}
    assert isinstance(line["correct"], bool)
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["checks"]) == set(manifest.limits(cell))
    wanted = manifest.cell_metrics(manifest.load(), cell)
    if trace:
        assert "breakdown" in line
        assert set(line["metrics"]) <= {m["name"]
                                        for m in wanted["per_layer"]}
    else:
        assert set(line["metrics"]) == {m["name"]
                                        for m in wanted["end_to_end"]}


def test_the_mesh_path_runs_and_is_correct(dry_run):
    """The eval runner's mesh path: four spawned sp ranks over gloo, one
    MAX and one SUM a batch, the same result line."""
    code, line = dry_run("iwae2l-eval", trace=1, **SP4)
    assert code == 0 and line["correct"] is True and line["attempted"] > 0


def test_without_a_card_a_run_prints_no_result(capsys):
    from portbench.tests.conftest import load_run
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    code = load_run().main(["--workload", CELLS[0], "--seed", "1",
                            "--seconds", "1"])
    assert code != 0 and capsys.readouterr().out == ""

"""The timed path broken underneath a run (on the CPU, the harness's look
for a card skipped): ``correct`` comes out false for each fault the cell
can have."""

from __future__ import annotations

import pytest

from portbench.tests.conftest import SP4

FAULTS = [
    ("iwae2l-train", "unchanged_state"), ("iwae2l-train", "half_batch"),
    ("iwae1l-train", "unchanged_state"), ("iwae1l-train", "half_batch"),
    ("iwae2l-eval", "altered_answer"), ("iwae2l-eval", "half_rows"),
]


@pytest.mark.parametrize("cell, fault", FAULTS)
def test_a_broken_program_is_not_correct(dry_run, cell, fault):
    code, line = dry_run(cell, patch=fault)
    assert code == 0 and line["correct"] is False


@pytest.mark.parametrize("fault", ["no_exchange", "altered_answer"])
def test_a_broken_mesh_is_not_correct(dry_run, fault):
    """The eval runner on four sp ranks: each rank finalising its own
    samples, or two answers swapped, is caught."""
    code, line = dry_run("iwae2l-eval", patch=fault, **SP4)
    assert code == 0 and line["correct"] is False

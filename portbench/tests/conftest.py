"""Shared by the benchmark's tests: a dry run of a cell on the CPU, at a
size a test can hold, and its result line."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest

from portbench.tests import faults

RUN = Path(__file__).resolve().parent.parent / "run.py"

#: traffic overrides of each cell's dry run: full widths, fewer rows and
#: samples
DRY = {
    "iwae2l-train": {"n_train": 300},
    "iwae1l-train": {"n_train": 300},
    "iwae2l-eval": {"n_train": 200, "n_test": 40, "eval_batch": 20,
                    "nll_k": 500, "check_batches": 2, "profile_batches": 1},
}

#: the eval runner's mesh path (one process per rank; gloo on the CPU):
#: the k=5000 NLL's samples split over four sp ranks
SP4 = {"sp": 4, "nll_k": 1000}


def load_run():
    spec = importlib.util.spec_from_file_location("portbench_run", RUN)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def dry_run(capsys):
    """``dry_run(workload, trace=0, patch=None, **traffic) -> (exit code,
    result line or None)``; `traffic` overrides the dry sizes."""
    import torch

    def go(workload, trace=0, patch=None, **traffic):
        threads = torch.get_num_threads()
        torch.set_num_threads(2)
        try:
            dry = {"traffic": dict(DRY[workload], **traffic)}
            if patch:
                dry["patch"] = f"portbench.tests.faults:{patch}"
            code = load_run().main(
                ["--workload", workload, "--seed", "2147483659",
                 "--seconds", "0.2", "--trace", str(trace)], dry=dry)
        finally:
            torch.set_num_threads(threads)
            faults.restore()
        lines = capsys.readouterr().out.strip().splitlines()
        return code, (json.loads(lines[-1]) if lines else None)
    return go

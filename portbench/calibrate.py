#!/usr/bin/env python3
"""The readings the limits of ``portbench/checks/`` are set from.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--out PATH.json]

For each seed, at the cell's own sizes, it prints one JSON line of the
numbers the cell compares (``checks/<workload>.json`` names them):

* ``program``: the port's readings (cells on one card: the warm call of
  training, or the check's batches of evaluation, through the same calls
  the run makes); a mesh's come from its runs;
* ``control``: the reference in the program's place, its matmul operands
  rounded to fp8 (e4m3, per-tensor scale), one precision below the
  configuration's bf16;
* the faults the cell can have, planted in the reference put in the
  program's place: ``half_batch`` (training: half of each batch, the mean
  over the rest), ``half_samples``, ``altered_answer`` (two rows' answers
  swapped) and, on a mesh, ``no_exchange`` (rank 0's samples alone).
  A state left unchanged reads 1 by the training measure and needs no run.

The benchmark's own runs do not run this. Needs the card, like a run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def train_readings(cell, seed: int, dev) -> dict:
    from portbench.harness import compare, train_pass
    from portbench.reference import iwae as ref

    s = train_pass.warm_call(cell, dev, seed)
    s.pop("state"), s.pop("epoch")
    ref.no_tf32()
    r = train_pass.reference_checks(cell, seed, s)

    def in_place(other):
        return {"losses": other["losses"], "first_grad": other["first_grad"],
                "after": {n: s["w0"][n] + other["change"][n]
                          for n in other["change"]}, "w0": s["w0"]}
    ctrl = train_pass.reference_checks(cell, seed, s, q=ref.fp8)
    half = train_pass.reference_checks(cell, seed, s, rows=s["B"] // 2)
    out = {"program": train_pass.judge(s, r),
           "control": train_pass.judge(in_place(ctrl), r),
           "half_batch": train_pass.judge(in_place(half), r)}
    # beside the first steps' loss gap, that of every step of the call
    for name, got in (("program", s), ("control", ctrl), ("half_batch", half)):
        out[name]["loss_gap_call"] = compare.loss_gap(got["losses"],
                                                      r["losses"])
    return out


def eval_readings(cell, seed: int, dev) -> dict:
    import torch
    from portbench.harness import compare, eval_nll, inputs, program
    from portbench.reference import iwae as ref
    from portbench.reference.iwae import Widths

    t = cell.traffic
    widths = Widths.from_config(cell.config)
    x_train, x_test = inputs.synthetic_rows(seed, (t["n_train"], t["n_test"]),
                                            dev)
    w = inputs.init_weights(seed, widths, x_train)
    cell.seed = seed
    mine = {}
    if t["dp"] * t["sp"] == 1:
        from iwae_replication_project_tpu_torch.evaluation.metrics import (
            streaming_log_px)
        model_cfg = program.experiment_config(cell.config).model_config(dev)
        _, tree = program.param_tree(w, widths, requires_grad=False)
        gen = torch.Generator(device=dev)
        for b in range(t["check_batches"]):
            at = (b % (t["n_test"] // t["eval_batch"])) * t["eval_batch"]
            gen.manual_seed(inputs.sub_seed(seed, "eval", b, 0))
            mine[b] = streaming_log_px(tree, model_cfg,
                                       x_test[at:at + t["eval_batch"]],
                                       t["nll_k"], t["nll_chunk"],
                                       generator=gen)
    ref.no_tf32()
    out = {k: 0.0 for k in ("program", "control", "half_samples",
                            "altered_answer", "no_exchange")}
    k_rank = t["nll_k"] // t["sp"]
    for b in range(t["check_batches"]):
        want = eval_nll.reference_rows(cell, w, x_test, b, dev)
        got = {"control": eval_nll.reference_rows(cell, w, x_test, b, dev,
                                                  q=ref.fp8),
               "half_samples": eval_nll.reference_rows(
                   cell, w, x_test, b, dev, samples=k_rank // 2),
               "altered_answer": want[[1, 0] + list(range(2, len(want)))]}
        if t["sp"] > 1:
            one = dict(cell.traffic, sp=1, nll_k=k_rank)
            got["no_exchange"] = eval_nll.reference_rows(
                dataclasses.replace(cell, traffic=one), w, x_test, b, dev)
        if b in mine:
            got["program"] = mine[b]
        for name, rows in got.items():
            out[name] = max(out[name], compare.row_gap(rows, want))
    if not mine:
        del out["program"]
    if t["sp"] == 1:
        del out["no_exchange"]
    return {name: {"row_gap_nats": v} for name, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "portbench_run", Path(__file__).resolve().parent / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    from portbench.harness import program

    seeds = [int(s) for s in args.seeds.split(",")]
    cell = run.make_cell(run.parse(["--workload", args.workload, "--seed",
                                    str(seeds[0]), "--seconds", "0"]))
    program.prepare(cell)
    readings = train_readings if cell.traffic["kind"] == "train_pass" \
        else eval_readings
    rows = []
    for seed in seeds:
        row = {"seed": seed, **readings(cell, seed, torch.device("cuda"))}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

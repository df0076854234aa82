"""``BENCHMARK.json`` against the benchmark's contract, and every file the
harness finds by a name in it."""

from __future__ import annotations

import json

import pytest

from portbench.harness import flops, manifest
from portbench.reference.iwae import Widths

M = manifest.load()
METRICS = M["end_to_end"] + M["per_layer"]
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_are_the_contracts():
    assert set(M) == KEYS["top"]
    for c in M["configs"]:
        assert set(c) == KEYS["config"]
    for w in M["workloads"]:
        assert set(w) == KEYS["workload"]
    for kind in ("end_to_end", "per_layer"):
        for m in M[kind]:
            assert set(m) - {"workloads"} == KEYS[kind], m["name"]


def test_names_units_and_lines_pass_the_character_rules():
    names = [e["name"] for e in M["configs"] + M["workloads"] + METRICS]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in M["workloads"]]:
        assert manifest.NAME.match(n), n
    for m in METRICS:
        assert manifest.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for e in M["configs"] + M["workloads"]:
        assert _line(e["why"])
    for c in M["configs"]:
        assert _line(c["source"]) and len(c["reduced"]) <= 16
    for m in M["per_layer"]:
        assert _line(m["layer"])
    assert all(_line(w) for w in M["command"]) and len(M["command"]) <= 32
    assert len(json.dumps(M)) <= 64 * 1024


def test_command_paths_and_sizes():
    assert M["paths"] == ["portbench"]
    assert M["command"] == ["python3", "portbench/run.py"]
    assert 1 <= M["run_seconds"] <= 51
    cells = len(M["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(M["configs"]) <= 24
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= max(1, cells // 4)
    assert all(w["chips"] in (1, 4) for w in M["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_bounds_and_sources():
    names = [m["name"] for m in M["end_to_end"]]
    assert "setup_s" in names and 1 <= len(names) <= 16
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in names


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_finds_its_files_and_reports_enough(cell):
    w = manifest.by_name(M["workloads"], cell, "workload")
    config = manifest.config(M, w["config"])
    traffic = manifest.traffic(w["traffic"])
    assert traffic["kind"] in ("train_pass", "eval_nll")
    assert traffic["rate_metric"] in {m["name"] for m in
                                      manifest.cell_metrics(M, cell)[
                                          "end_to_end"]}
    limits = manifest.limits(cell)
    assert limits and all(v > 0 for v in limits.values())
    got = manifest.cell_metrics(M, cell)
    e2e = {m["name"] for m in got["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and got["per_layer"]
    if traffic["kind"] == "eval_nll":
        assert traffic["dp"] * traffic["sp"] == w["chips"]
    else:
        assert w["chips"] == 1
    assert config["name"] == w["config"]


@pytest.mark.parametrize("entry", M["configs"], ids=lambda c: c["name"])
def test_configuration_files_hold_what_runs(entry):
    c = json.loads((manifest.ROOT / entry["file"]).read_text())
    assert entry["file"].startswith("portbench/")
    # each key changed from the source is in the file, its value's reason
    # under `assumed`, and none is a width
    assert c["reduced"] == entry["reduced"]
    for key in c["reduced"]:
        assert key in c and key in c["assumed"]
        assert not key.endswith(("_dim", "_rank")) and "hidden" not in key \
            and "latent" not in key
    assert c["source"] == entry["source"]
    assert flops.param_count(Widths.from_config(c)) == c["parameters"]
    from portbench.harness import program
    assert set(program.FIELDS) >= {"k", "batch_size", "compute_dtype"}
    assert all(k in c for k in ("preset", "learning_rate", "adam_betas"))


@pytest.mark.parametrize("m", M["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_its_reader(m):
    reader = manifest.metric_reader(m["name"])
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == \
        (m["unit"], m["layer"], m["moves"])
    assert callable(reader.read)
    for cell in m.get("workloads", []):
        reports = {e["name"] for e in manifest.cell_metrics(
            M, cell)["end_to_end"]}
        assert m["moves"] in reports, (m["name"], cell)


def test_metrics_of_one_layer_share_its_name():
    layers = {m["layer"] for m in M["per_layer"]}
    assert layers == {"step", "epoch", "kernels", "device", "whole step",
                      "evaluation", "whole pass"}

"""The production rehearsal (``scripts/torch_dress_rehearsal.py``) and the
dataset report (``scripts/torch_prepare_data.py``) on the CPU at a tiny
size: the fixtures in the reference's formats, read back by the loaders;
the summary carries JAX's fields and the port's; a resumed run reports
itself and writes nothing."""

import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from iwae_replication_project_tpu.data import loaders as jax_loaders
from iwae_replication_project_tpu_torch.data import load_dataset

REPO = Path(__file__).resolve().parent.parent

#: tiny (train, test) rows: 3 batches of 100 a pass, one eval batch
SIZES = (300, 60)
#: test widths (2 layers, as the preset), 2 stages and a small NLL
OVERRIDES = dict(n_hidden_encoder=(24, 16), n_hidden_decoder=(16, 24),
                 n_latent_encoder=(16, 8), n_latent_decoder=(16, 784),
                 k=5, eval_k=5, n_stages=2, nll_k=20, nll_chunk=10,
                 activity_samples=50)

#: the fields the port adds to JAX's summary and stage rows
PORT_KEYS = {"data_load_seconds", "eval_batch_used", "raw_means_bias",
             "launches", "launches_expected", "card", "passes_scale",
             "jax_final_NLL", "gap", "bound"}
PORT_STAGE_KEYS = {"ms_per_step", "captures", "capture_seconds", "replays",
                   "libraries_found_built", "nvcc_builds", "nvcc_seconds"}


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def rehearsal():
    return _script("torch_dress_rehearsal")


def test_sizes_are_jax_scripts(rehearsal):
    jax_script = (REPO / "scripts" / "dress_rehearsal.py").read_text()
    for name, (n_train, n_test) in rehearsal.SIZES.items():
        assert f'"{name}": ({n_train:_}, {n_test:_})' in jax_script


@pytest.mark.parametrize("dataset", ["binarized_mnist", "omniglot",
                                     "fashion_mnist"])
def test_fixture_files_read_back_and_are_idempotent(rehearsal, dataset,
                                                    tmp_path):
    d = str(tmp_path)
    assert rehearsal.make_fixture_files(dataset, d, SIZES) > 0.0
    assert rehearsal.make_fixture_files(dataset, d, SIZES) == 0.0
    ds = load_dataset(dataset, data_dir=d, allow_synthetic=False)
    binary = dataset == "binarized_mnist"
    x_train, x_test = jax_loaders._synthetic(dataset, *SIZES, seed=0,
                                             binary=binary)
    if dataset == "fashion_mnist":  # through uint8 idx bytes
        x_train, x_test = ((x * 255).astype(np.uint8).astype(np.float32)
                           / 255.0 for x in (x_train, x_test))
    np.testing.assert_array_equal(ds.x_train, x_train)
    np.testing.assert_array_equal(ds.x_test, x_test)
    assert ds.bias_source == ("raw" if binary else "train")
    assert ds.binarization == ("none" if binary else "stochastic")


def test_run_summary_and_resume(rehearsal, tmp_path, capsys):
    kw = dict(data_dir=str(tmp_path / "data"), checkpoint_every_passes=1,
              device="cpu", root=str(tmp_path), sizes=SIZES,
              overrides=OVERRIDES)
    summary, written = rehearsal.run("binarized_mnist", fresh=True, **kw)
    with open(REPO / "results" / "dress_rehearsal.json") as f:
        jax = json.load(f)
    assert set(jax) <= set(summary) and PORT_KEYS <= set(summary)
    assert len(summary["stages"]) == 2
    for row in summary["stages"]:
        assert set(jax["stages"][0]) | {"checkpoint_seconds"} \
            | PORT_STAGE_KEYS <= set(row)
        assert np.isfinite(row["NLL"]) and row["train_seconds"] > 0
    assert [r["passes"] for r in summary["stages"]] == [1, 3]
    assert summary["steps"] == 4 * 3 and summary["eval_batch_used"] == 60
    assert summary["raw_means_bias"] and not summary["synthetic_data"]
    assert summary["launches"] == {"hot_loop_fwd": 0, "hot_loop_bwd": 0}
    # 2 evaluations of one batch: 1 + 2 chunks + 2 pruned + 1 diagnostics
    assert summary["launches_expected"] == {"hot_loop_fwd": 12 + 2 * 6,
                                            "hot_loop_bwd": 12}
    assert summary["jax_final_NLL"] == jax["stages"][1]["NLL"]
    assert summary["gap"] == pytest.approx(
        summary["stages"][-1]["NLL"] - jax["stages"][1]["NLL"], abs=2e-3)
    assert not summary["held"] and not summary["resumed"]
    assert written == rehearsal.out_json("binarized_mnist", str(tmp_path),
                                         scaled=True)
    with open(written) as f:
        assert json.load(f) == json.loads(json.dumps(summary))
    assert "wrote" in capsys.readouterr().out

    os.remove(written)
    again, written = rehearsal.run("binarized_mnist", fresh=False, **kw)
    assert again["resumed"] and written is None and again["stages"] == []
    assert not os.path.exists(rehearsal.out_json(
        "binarized_mnist", str(tmp_path), scaled=True))
    assert "partial/resumed run" in capsys.readouterr().out


def test_protocol_run_writes_the_committed_name(rehearsal, tmp_path):
    assert rehearsal.out_json("binarized_mnist", str(tmp_path)).endswith(
        "results/torch_dress_rehearsal.json")
    assert rehearsal.out_json("omniglot", str(tmp_path)).endswith(
        "results/torch_dress_rehearsal_omniglot.json")
    assert rehearsal.out_json("fashion_mnist", str(tmp_path),
                              scaled=True).endswith(
        "results/torch_dress_rehearsal_fashion_mnist_scaled.json")
    cfg = rehearsal.rehearsal_config("omniglot", root=str(tmp_path))
    assert (cfg.n_stages, cfg.k, cfg.loss_function, cfg.passes_scale) == \
        (8, 50, "IWAE", 1.0)
    assert not cfg.allow_synthetic and not cfg.save_figures and cfg.resume
    assert cfg.compile_cache_dir.startswith(cfg.checkpoint_dir)
    # the eval batch Omniglot's 8,070 test rows clamp to, and its launches
    assert rehearsal.eval_b1_launches(cfg, 8070) == 30 * 21 + 20 + 30


def test_prepare_data_report(tmp_path, capsys, rehearsal):
    prep = _script("torch_prepare_data")
    rehearsal.make_fixture_files("omniglot", str(tmp_path), SIZES)
    out = tmp_path / "digits.npz"
    assert prep.main(["--data-dir", str(tmp_path), "--device", "cpu",
                      "--export-digits", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    status = {ln.split()[0]: ln.split()[1] for ln in lines[1:]
              if ln.startswith("  ")}
    assert status == {"binarized_mnist": "MISSING", "mnist": "MISSING",
                      "fashion_mnist": "MISSING", "omniglot": "REAL",
                      "digits": "REAL", "digits_gray": "REAL"}
    assert "train=(300, 784) test=(60, 784) binarization=stochastic" in \
        next(ln for ln in lines if "omniglot" in ln)
    with np.load(out) as z:
        assert z["x_train"].shape == (1500, 784)


def test_scripts_need_the_card_unless_told(tmp_path):
    """Without --device both default to the card: with no card visible
    they fail, and before writing any fixture."""
    import subprocess
    for script in ("torch_prepare_data.py", "torch_dress_rehearsal.py"):
        proc = subprocess.run(
            [sys.executable, str(REPO / "scripts" / script), "--data-dir",
             str(tmp_path)], capture_output=True, text=True, timeout=120,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert os.listdir(tmp_path) == []  # no fixture was written

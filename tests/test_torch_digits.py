"""The digits data the port carries (``data/digits.csv.gz``) against
scikit-learn's ``load_digits`` and the JAX package's loaders, loaded with
scikit-learn blocked; and ``scripts/torch_digits_cross_check.py``: both
halves and the merge at a tiny size, and the committed artifact against
its own bound."""

import hashlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from iwae_replication_project_tpu.data import loaders as jloaders
from iwae_replication_project_tpu_torch.data import loaders as tloaders

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "scripts" / "torch_digits_cross_check.py"
ARTIFACT = REPO / "results" / "torch_port_cross_check.json"


@pytest.fixture
def no_sklearn(monkeypatch):
    """``import sklearn`` (and its submodules) raises ImportError."""
    for name in [m for m in sys.modules if m == "sklearn"
                 or m.startswith("sklearn.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "sklearn", None)


def test_the_copy_is_sklearns_file_and_parses_as_load_digits():
    from sklearn.datasets import load_digits

    path = Path(tloaders.DIGITS_CSV)
    assert path.stat().st_size == 57523
    assert hashlib.sha256(path.read_bytes()).hexdigest() == (
        "09f66e6debdee2cd2b5ae59e0d6abbb73fc2b0e0185d2e1957e9ebb51e23aa22")
    pixels, labels = tloaders.digits_table()
    want = load_digits()
    assert pixels.dtype == want.data.dtype and labels.shape == (1797,)
    assert np.array_equal(pixels, want.data)
    assert np.array_equal(pixels.reshape(-1, 8, 8), want.images)
    assert np.array_equal(labels, want.target)


@pytest.mark.parametrize("name", ["digits", "digits_gray"])
def test_port_loads_digits_without_sklearn_as_jax_does(name, no_sklearn):
    with pytest.raises(ImportError):
        import sklearn  # noqa: F401
    got = tloaders.load_dataset(name, allow_synthetic=False)
    assert not got.synthetic
    sys.modules.pop("sklearn")  # the JAX loader reads sklearn's copy
    want = jloaders.load_dataset(name, allow_synthetic=False)
    for field in ("x_train", "x_test", "bias_means"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert (got.binarization, got.bias_source) == (want.binarization,
                                                   want.bias_source)


def test_digits_labels_equal_jax(no_sklearn):
    from iwae_replication_project_tpu_torch.data import digits_labels

    got = digits_labels()
    sys.modules.pop("sklearn")
    want = jloaders.digits_labels()
    assert [g.shape for g in got] == [(1500,), (297,)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# --------------------------------------------------------------------------
# the cross-check script
# --------------------------------------------------------------------------

def _script():
    spec = importlib.util.spec_from_file_location("digits_cross_check",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cross_check_halves_and_merge_at_a_tiny_size(tmp_path):
    """Both halves on the CPU at test widths (2 stages, 2 batches a pass,
    seeds 0-1) and the merge: the document's shape, the bound's rule."""
    cc = _script()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jax_half, port_half = tmp_path / "jax.json", tmp_path / "port.json"
        assert cc.main(["--jax", "--tiny", "--jax-half", str(jax_half)]) == 0
        assert cc.main(["--port", "--tiny", "--device", "cpu",
                        "--port-half", str(port_half)]) == 0
        out = tmp_path / "merged.json"
        assert cc.main(["--merge", "--jax-half", str(jax_half),
                        "--port-half", str(port_half), "--out",
                        str(out)]) == 0
    finally:
        torch.set_num_threads(n)
    doc = json.loads(out.read_text())
    assert set(doc["gaps"]) == set(cc.CONFIGS)
    for name, g in doc["gaps"].items():
        j = doc["jax"]["configs"][name]
        p = doc["port"]["configs"][name]
        assert len(j["curves"]) == len(p["curves"]) == 2
        nll = np.array([c["NLL_by_stage"] for c in j["curves"]])
        assert nll.shape == (2, 2) and np.isfinite(nll).all()
        se = nll.std(axis=0, ddof=1) / np.sqrt(2)
        np.testing.assert_allclose(
            g["bound"], np.maximum(cc.BOUND_FLOOR, 3 * np.sqrt(2) * se))
        np.testing.assert_allclose(
            g["gap_NLL"], np.mean([c["NLL_by_stage"] for c in p["curves"]],
                                  axis=0) - nll.mean(axis=0))
        assert g["inside"] == [abs(a) <= b for a, b in zip(g["gap_NLL"],
                                                           g["bound"])]
    assert doc["all_inside"] == all(all(g["inside"])
                                    for g in doc["gaps"].values())
    assert doc["port"]["device"] == "cpu" and "card" not in doc["port"]


def test_committed_cross_check_sits_inside_its_bound():
    """The artifact the card run wrote: configurations (a) IWAE, (a) DReG
    and (b), five stages, the port on the card against JAX on the CPU, each
    stage's gap of the means inside the bound the JAX half set."""
    doc = json.loads(ARTIFACT.read_text())
    cc = _script()
    assert set(doc["gaps"]) == set(cc.CONFIGS)
    assert doc["port"]["device"] == "cuda" and "H100" in doc["port"]["card"]
    for name, g in doc["gaps"].items():
        j, p = doc["jax"]["configs"][name], doc["port"]["configs"][name]
        assert len(g["gap_NLL"]) == cc.N_STAGES
        assert j["bound"] == g["bound"]
        means = np.mean([c["NLL_by_stage"] for c in p["curves"]], axis=0)
        assert np.all(np.abs(means - np.asarray(j["mean_NLL"]))
                      <= np.asarray(j["bound"])), name
